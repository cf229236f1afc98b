"""Pass 2: CUDA kernel verifier (KRN001-KRN004), the counterpart of
``repro/analysis/check/kernel_pass.py``.

Consumes :mod:`repro_torch.kernels.registry` metadata; no kernel is
launched.

  * KRN001 the grid covers the extents: each grid axis's blocks times its
    tile reach the extent it walks (the kernels mask ragged edges; a
    kernel that does not needs extents that divide its tiles).
  * KRN002 output coverage and races: every grid point's output tile is
    enumerated; a tile written by two points that differ outside the
    declared reduction axes is a race, a tile no point writes a hole.
    Where the blocks take data-dependent runs of a flattened output
    (``gmm_rescore``'s work items), the runs must partition it and fit
    the grid.
  * KRN003 async-copy discipline, read from the ``.cu`` source (the
    namespace that holds the ring): a ``cp.async`` ring issues copies,
    commits them (``cp_commit``), waits with at most stages - 2 groups in
    flight (``cp_wait<n>``) and indexes its slots modulo its stages (the
    source's STAGES equal to the registry's); a TMA ring issues loads
    (``tma_load_*``), arms a barrier with their bytes
    (``bar_expect_tx``), waits on it (``bar_wait``), and with more than
    one stage releases slots (``bar_arrive``) and indexes them and their
    phase by the stages. A kernel with no declared ring issues neither.
  * KRN004 shared memory: a block's bytes against the card's opt-in limit
    (``shared_memory_per_block_optin``; 232,448 on the H100, ``budget``
    on the card).
"""
from __future__ import annotations

import itertools
import re
from typing import List, Optional

from repro_torch.analysis.check.findings import Finding, make_finding

SMEM_BUDGET_BYTES = 232448   # H100 shared_memory_per_block_optin

_CP_START = re.compile(r"\bcp_async\w*\s*\(")
_CP_COMMIT = re.compile(r"\bcp_commit\s*\(")
_CP_WAIT = re.compile(r"\bcp_wait\s*<([^>]*)>")
_TMA_START = re.compile(r"\btma_load\w*\s*\(")
_TMA_ARM = re.compile(r"\bbar_expect_tx\s*\(")
_TMA_WAIT = re.compile(r"\bbar_wait\s*\(")
_TMA_RELEASE = re.compile(r"\bbar_arrive\s*\(")
_MOD_STAGES = re.compile(r"%\s*STAGES\b")
_PHASE = re.compile(r"/\s*STAGES\s*\)\s*&\s*1")
_STAGES = re.compile(r"constexpr\s+int\s+STAGES\s*=\s*(\d+)\s*;")
_FUNC = re.compile(r"__device__[^;{]*?\b(\w+)\s*\([^;{]*\)\s*\{")


def _block(text: str, start: int) -> str:
    """The brace-matched block whose '{' is at or after ``start``."""
    i = text.index("{", start)
    depth = 0
    for j in range(i, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                return text[i:j + 1]
    return text[i:]


def _scope(text: str, scope: Optional[str]) -> str:
    """The text of ``namespace scope { ... }`` (the file for None)."""
    if scope is None:
        return text
    m = re.search(rf"\bnamespace\s+{re.escape(scope)}\s*\{{", text)
    return _block(text, m.start()) if m else ""


def _copy_helpers(text: str) -> List[str]:
    """Names of the file's device functions that issue cp.async copies, so
    that a call of one counts as a copy (``copy16`` in packed_matmul.cu)."""
    out = []
    for m in _FUNC.finditer(text):
        if _CP_START.search(_block(text, m.end() - 1)):
            out.append(m.group(1))
    return out


def _cp_starts(text: str, body: str) -> int:
    n = len(_CP_START.findall(body))
    for name in _copy_helpers(text):
        if not name.startswith("cp_async"):
            n += len(re.findall(rf"\b{name}\s*\(", body))
    return n


def _wait_depth(expr: str, stages: int) -> Optional[int]:
    """The groups a ``cp_wait<expr>`` leaves in flight, for an expr ``n``
    or ``STAGES - n`` with STAGES = ``stages``; None for any other."""
    m = re.fullmatch(r"\s*(STAGES\s*-\s*)?(\d+)\s*", expr)
    if m is None:
        return None
    return stages - int(m.group(2)) if m.group(1) else int(m.group(2))


def _check_divisibility(spec, inst) -> List[Finding]:
    out: List[Finding] = []
    loc = f"kernel:{spec.name}"
    for a, (g, ax) in enumerate(zip(inst.grid, inst.axes)):
        if g * ax.tile < ax.extent:
            out.append(make_finding(
                "KRN001", loc,
                f"grid axis {a} ({ax.name}): {g} blocks x tile {ax.tile} "
                f"= {g * ax.tile} < extent {ax.extent}",
                "launch ceil(extent / tile) blocks and mask the ragged "
                "edge in the kernel"))
        elif ax.extent % ax.tile and not spec.masks_ragged:
            out.append(make_finding(
                "KRN001", loc,
                f"grid axis {a} ({ax.name}): extent {ax.extent} not "
                f"divisible by tile {ax.tile} and the kernel does not mask "
                "ragged edges",
                "mask the ragged edge in the kernel, or pad the operands "
                "to a tile multiple in the wrapper"))
    return out


def _check_races_and_coverage(spec, inst) -> List[Finding]:
    out: List[Finding] = []
    loc = f"kernel:{spec.name}"
    red = set(spec.reduction_axes)
    grid_points = list(itertools.product(*[range(g) for g in inst.grid]))
    for bm in inst.outputs:
        writers = {}
        for pt in grid_points:
            writers.setdefault(tuple(bm.index_map(*pt)), []).append(pt)
        for idx, pts in writers.items():
            non_red = {tuple(c for a, c in enumerate(pt) if a not in red)
                       for pt in pts}
            if len(non_red) > 1:
                out.append(make_finding(
                    "KRN002", loc,
                    f"output '{bm.name}' tile {idx} written by "
                    f"{len(pts)} grid points differing outside declared "
                    f"reduction axes {sorted(red) or '()'}",
                    "make the tile index injective over the non-reduction "
                    "grid axes, or declare the axis a reduction with an "
                    "init/accumulate body"))
                break
        nblocks = tuple(-(-dim // blk)
                        for dim, blk in zip(bm.array_shape, bm.block))
        missing = (set(itertools.product(*[range(n) for n in nblocks]))
                   - set(writers))
        if missing:
            out.append(make_finding(
                "KRN002", loc,
                f"output '{bm.name}' tiles never written: "
                f"{sorted(missing)[:4]}{'...' if len(missing) > 4 else ''}",
                "extend the grid or fix the tile index so every output "
                "tile has a writer"))
    if inst.runs is not None:
        covered = 0
        for first, n in sorted(inst.runs):
            if first != covered:
                what = "overlaps" if first < covered else "leaves a gap at"
                out.append(make_finding(
                    "KRN002", loc,
                    f"the blocks' runs {what} element {min(first, covered)}"
                    f" of {inst.run_extent}",
                    "cut the flattened output into disjoint runs that "
                    "cover it"))
                break
            covered += n
        else:
            if covered != inst.run_extent:
                out.append(make_finding(
                    "KRN002", loc,
                    f"the blocks' runs cover {covered} of "
                    f"{inst.run_extent} elements",
                    "cut the flattened output into runs that cover it"))
        if len(inst.runs) > inst.grid[0]:
            out.append(make_finding(
                "KRN002", loc,
                f"{len(inst.runs)} runs for a grid of {inst.grid[0]} "
                "blocks: the runs past the grid are never written",
                "size the grid from the runs' upper bound"))
    return out


def _check_rings(spec, inst) -> List[Finding]:
    out: List[Finding] = []
    loc = f"kernel:{spec.name}"
    try:
        text = spec.path.read_text()
    except OSError:
        return [make_finding(
            "KRN003", loc, f"kernel source {spec.path} unreadable; "
            "async-copy discipline unverifiable",
            "register the .cu file that holds the kernel")]

    def bad(msg, hint):
        out.append(make_finding("KRN003", loc, msg, hint))

    if not inst.rings:
        body = _scope(text, inst.scope)
        n_cp, n_tma = _cp_starts(text, body), len(_TMA_START.findall(body))
        if n_cp or n_tma:
            bad(f"async copies ({n_cp} cp.async, {n_tma} TMA) in a kernel "
                "with no declared ring",
                "declare the ring in the registry so its discipline is "
                "verified")
        return out
    for ring in inst.rings:
        body = _scope(text, ring.scope)
        m = _STAGES.search(body)
        if ring.stages > 1 and (m is None or int(m.group(1)) != ring.stages):
            bad(f"{ring.kind} ring of {ring.stages} stages in the registry, "
                f"STAGES = {m.group(1) if m else 'none'} in the source",
                "keep the registry's stages equal to the source's")
        if ring.kind == "cp.async":
            starts = _cp_starts(text, body)
            if starts == 0:
                bad("declared cp.async ring but the kernel issues no "
                    "cp.async copy", "drop the ring or issue the copies")
                continue
            if not _CP_COMMIT.search(body):
                bad(f"{starts} cp.async copies never committed: "
                    "cp.async.wait_group waits only committed groups",
                    "cp_commit() after each stage's copies")
            waits = _CP_WAIT.findall(body)
            if not waits:
                bad(f"{starts} cp.async copies with no wait: in-flight "
                    "data read", "cp_wait<STAGES - 2>() before a slab is "
                    "read")
            allowed = max(ring.stages - 2, 0)
            for w in waits:
                v = _wait_depth(w, ring.stages)
                if v is None or v > allowed:
                    bad(f"cp_wait<{w.strip()}> leaves {v} groups in "
                        f"flight, above {allowed}: the slab read next may "
                        "not have landed",
                        "wait with STAGES - 2 (or fewer) groups pending")
            if ring.stages > 1 and not _MOD_STAGES.search(body):
                bad(f"ring of {ring.stages} stages but no modular slot "
                    "indexing (% STAGES)", "index slots with s % STAGES")
        elif ring.kind == "tma":
            if not _TMA_START.search(body):
                bad("declared TMA ring but the kernel issues no TMA load",
                    "drop the ring or issue the loads")
                continue
            if not _TMA_ARM.search(body):
                bad("TMA loads with no barrier armed with their bytes "
                    "(expect_tx): the wait never completes",
                    "bar_expect_tx(full barrier, bytes) before the loads")
            if not _TMA_WAIT.search(body):
                bad("TMA loads never waited: in-flight tiles read",
                    "bar_wait on the slot's full barrier before reading")
            if ring.stages > 1:
                if not _TMA_RELEASE.search(body):
                    bad("ring slots never released (no bar_arrive on an "
                        "empty barrier): the producer deadlocks on reuse",
                        "bar_arrive(empty barrier) when a slot is read")
                if not _MOD_STAGES.search(body) or not _PHASE.search(body):
                    bad(f"ring of {ring.stages} stages without slot "
                        "indexing (% STAGES) and phase parity "
                        "((j / STAGES) & 1)",
                        "index slots with j % STAGES and wait on phase "
                        "(j / STAGES) & 1")
        else:
            bad(f"unknown ring kind {ring.kind!r}", "'cp.async' or 'tma'")
    return out


def _check_smem(spec, inst, budget: int) -> List[Finding]:
    if inst.smem_bytes > budget:
        return [make_finding(
            "KRN004", f"kernel:{spec.name}",
            f"{inst.smem_bytes} bytes of shared memory a block, above the "
            f"{budget} a block may opt in to",
            "shrink the tiles, the ring's stages or the rows a block "
            "keeps")]
    return []


def check_kernel(spec, config: Optional[dict] = None,
                 budget: int = SMEM_BUDGET_BYTES) -> List[Finding]:
    """KRN001-KRN004 over one registered KernelSpec at ``config``
    (default: its ``default_config``)."""
    inst = spec.instance(config)
    findings: List[Finding] = []
    findings += _check_divisibility(spec, inst)
    findings += _check_races_and_coverage(spec, inst)
    findings += _check_rings(spec, inst)
    findings += _check_smem(spec, inst, budget)
    return findings


def check_all_kernels(budget: int = SMEM_BUDGET_BYTES) -> List[Finding]:
    """Every registered kernel at its default config and, for
    ``tvm_estep`` and the attention kernels, at each form's."""
    from repro_torch.kernels import registry
    out: List[Finding] = []
    for spec in registry.all_specs():
        for cfg in gate_configs(spec.name):
            out += check_kernel(spec, cfg, budget)
    return out


def gate_configs(name: str):
    """The configs the gate checks a kernel at: its default, plus one a
    form where the config picks the form."""
    if name == "tvm_estep":
        return [None, {"M": 16, "dtype": "float32"},
                {"M": 256, "dtype": "float32"}]
    if name in ("flash_attention", "flash_attention_bwd"):
        # f32, and bf16 at hd 256 (the forward's 64-row blocks, the
        # backward's 64-row blocks split over the query heads): Gemma 2B's
        # MQA prefill; bf16 at a head dim below its instance's width (16:
        # width 64), one the backward runs on the width-256 instance (176),
        # a multiple of 8 (40), one staged (33), and the widest (512: the
        # width-512 instances' column slices; in f32 the backward's two
        # gradient column slices and its dK/dV pass split over the query
        # heads) in both types
        return [None, {"dtype": "float32"},
                {"B": 4, "S": 2048, "H": 8, "KVH": 1, "hd": 256,
                 "dtype": "bfloat16"},
                {"hd": 16, "dtype": "bfloat16"},
                {"hd": 176, "dtype": "bfloat16"},
                {"hd": 40, "dtype": "bfloat16"},
                {"hd": 33, "dtype": "bfloat16"},
                {"hd": 512, "dtype": "bfloat16"},
                {"hd": 512, "dtype": "float32"}]
    if name == "selective_scan":
        # the tree form, a d_state between the instances, and past 64 the
        # state groups (4 at 256; 2, the last masked, at 100 in the tree)
        return [None, {"scan_dtype": "bfloat16"}, {"ds": 12}, {"ds": 256},
                {"ds": 100, "scan_dtype": "bfloat16"}]
    if name == "selective_scan_bwd":
        # the 64-state instance: 32 channels a block; past 64 the state
        # groups beside the channel blocks
        return [None, {"ds": 64}, {"ds": 129}]
    if name == "gmm_align":
        return [None, {"K": 40}, {"rescore_only": True}]
    if name == "gmm_loglik":
        # the rows form at each tile height (128, 64, 32 frames)
        return [None, {"D": 256}, {"D": 520}, {"D": 700}]
    if name == "bw_stats":
        # the pairs form: past 252, and a D that is not a multiple of 4
        return [None, {"D": 256}, {"D": 13}]
    return [None]
