"""Dry-run without a cluster: lower every (arch x shape) on the production
meshes, print its counts, derive the roofline terms (the port of
``repro/launch/dryrun.py``).

Usage (``--all``: both meshes, every cell):
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch ivector-tvm --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod-only

"Lowering" here runs rank 0's share of one step on meta tensors in a fake
world of 256 (16 x 16) or 512 (2 x 16 x 16) ranks
(``launch/mesh.fake_world``), counted by ``analysis/op_cost.py``: flops,
bytes, collective bytes by op and peak live bytes, read by
``analysis/roofline.py``'s H100 profile. Nothing is allocated and no
device is needed, so the CPU and the card give the same row. The
paper's model (``ivector-tvm``) lowers through
``launch/ivector_cell.lower_cell``; the LM archs give 'skipped' rows: their
train step is ported (ROADMAP.md Queue 1 item 14f), and they lower once
the sharding rules are (item 14g). Rows are cached as JSON under
``chiprun_out/dryrun/`` (or ``--out DIR``).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import (ALL_SHAPES, ARCH_IDS, PORTED_ARCH_IDS,
                                 get_config, get_shape)

OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out" / "dryrun"


def _lm_reason(arch: str) -> str:
    if arch not in PORTED_ARCH_IDS:
        return (f"{arch} is not ported to repro_torch (ROADMAP.md Queue 1 "
                "item 14)")
    return ("the LM train step is ported (ROADMAP.md Queue 1 item 14f); "
            "its cells lower once the sharding rules (item 14g) are")


def lower_cell(arch: str, shape_name: str, multi_pod: bool):
    """Lower one cell. Returns (counter or None, row dict)."""
    if arch == "ivector-tvm":
        from repro_torch.launch import ivector_cell
        return ivector_cell.lower_cell(shape_name, multi_pod)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    get_shape(shape_name)
    if arch in PORTED_ARCH_IDS:
        get_config(arch)
    return None, {"arch": arch, "shape": shape_name,
                  "mesh": "multi" if multi_pod else "single",
                  "status": "skipped", "reason": _lm_reason(arch)}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             skip_existing: bool = True, out_dir: Path = OUT_DIR):
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_tag = "multi" if multi_pod else "single"
    out = out_dir / f"{arch}__{shape_name}__{mesh_tag}.json"
    if skip_existing and out.exists():
        row = json.loads(out.read_text())
        if row.get("status") in ("ok", "skipped"):
            print(f"[cached] {arch} x {shape_name} x {mesh_tag}: "
                  f"{row.get('status')}")
            return row
    t0 = time.time()
    try:
        counter, row = lower_cell(arch, shape_name, multi_pod)
        if counter is not None:
            top = sorted(counter.kernels.items(), key=lambda kv: -kv[1][2])
            print({"flops": counter.flops, "bytes": counter.bytes,
                   "peak bytes": counter.peak_bytes,
                   "kernel regions": {k: v[0] for k, v in top}})
    except Exception as e:
        row = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    row.setdefault("lower_seconds", time.time() - t0)
    out.write_text(json.dumps(row, indent=2, default=str))
    status = row.get("status")
    extra = (f" dominant={row.get('dominant')} "
             f"rf={row.get('roofline_fraction', 0):.3f}"
             if status == "ok" else row.get("reason", row.get("error", "")))
    print(f"[{status}] {arch} x {shape_name} x {mesh_tag} "
          f"({row['lower_seconds']:.1f}s) {extra}")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", "--multipod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None,
                    help=f"directory of the JSON rows (default {OUT_DIR})")
    args = ap.parse_args(argv)
    out_dir = OUT_DIR if args.out is None else Path(args.out)

    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]

    if args.all:
        n_bad = 0
        for arch in ARCH_IDS:
            for shape in ALL_SHAPES:
                for mp in meshes:
                    row = run_cell(arch, shape.name, mp,
                                   skip_existing=not args.force,
                                   out_dir=out_dir)
                    n_bad += row.get("status") == "error"
        print(f"done; {n_bad} errors")
        raise SystemExit(1 if n_bad else 0)

    if not (args.arch and args.shape):
        ap.error("--arch/--shape or --all required")
    for mp in meshes:
        run_cell(args.arch, args.shape, mp, skip_existing=not args.force,
                 out_dir=out_dir)


if __name__ == "__main__":
    main()
