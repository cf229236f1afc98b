"""Dry-run without a cluster: lower every (arch x shape) on the production
meshes, print its counts, derive the roofline terms (the port of
``repro/launch/dryrun.py``).

Usage (``--all``: both meshes, every cell):
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch ivector-tvm --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        --arch stablelm-1.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod-only
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --layers 1 \
        --jobs 4 --out /tmp/rows      # every cell at full width, depth 1

"Lowering" here runs rank 0's share of one step on meta tensors in a fake
world of 256 (16 x 16) or 512 (2 x 16 x 16) ranks
(``launch/mesh.fake_world``), counted by ``analysis/op_cost.py``: flops,
bytes, collective bytes by op and peak live bytes, read by
``analysis/roofline.py``'s H100 profile. Nothing is allocated and no
device is needed, so the CPU and the card give the same row. The
paper's model (``ivector-tvm``) lowers through
``launch/ivector_cell.lower_cell``; an LM arch lowers its train, prefill
or decode step (``shape.kind``) under ``make_rules(mesh, cfg, shape)``,
its state, params, cache and batch meta DTensors placed by their logical
axes (``_shardings_for``), with the rules' fallbacks in the row. A cell
that ``shape_applicability`` refuses gives a 'skipped' row with its
reason. ``--layers N`` cuts every LM config to N layers (N periods for
Jamba; the row records it) and ``--jobs N`` lowers N cells at a time, each
in a process of its own. Rows are cached as JSON under
``chiprun_out/dryrun/`` (or ``--out DIR``).
"""
from __future__ import annotations

import argparse
import functools
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import ALL_SHAPES, ARCH_IDS, get_config, get_shape

OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out" / "dryrun"


def model_flops_estimate(cfg, shape) -> float:
    """Useful model FLOPs for the step (6ND train / 2ND inference), counting
    matmul-active params (embedding gathers excluded, LM-head matmul
    included once)."""
    from repro_torch.models import api
    max_seq = shape.seq_len if cfg.family == "audio" else 0
    n_active = api.n_active_params(cfg, max_seq=max_seq)
    n_embed = cfg.vocab_size * cfg.d_model
    n_matmul = n_active - n_embed
    if cfg.tie_embeddings:
        n_matmul += cfg.vocab_size * cfg.d_model  # tied head matmul is real
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_matmul * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_matmul * tokens
    return 2.0 * n_matmul * shape.global_batch  # decode: one token per seq


def _shardings_for(rules, struct, axes):
    """{name: DTensor placements} of a {name: (shape, dtype)} struct by
    its logical axes (the reference's ``NamedSharding`` tree)."""
    return {k: rules.placements(s, axes[k]) for k, (s, _) in struct.items()}


def _meta_tree(rules, struct, axes):
    """This rank's shards of ``struct`` as meta DTensors (nothing
    allocated); a scalar stays a plain meta tensor."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dm = rules.device_mesh
    out = {}
    for k, pl in _shardings_for(rules, struct, axes).items():
        shape, dt = struct[k]
        if not shape:
            out[k] = torch.zeros((), dtype=dt, device="meta")
            continue
        local, _ = compute_local_shape_and_global_offset(shape, dm, pl)
        out[k] = DTensor.from_local(
            torch.empty(local, dtype=dt, device="meta"), dm, pl,
            shape=torch.Size(shape), stride=torch.empty(
                shape, device="meta").stride(), run_check=False)
    return out


def _local_bytes(tree) -> int:
    from repro_torch.analysis.op_cost import tensors
    from repro_torch.sharding import is_dtensor
    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size() for t in tensors(tree))


def lower_lm(cfg, shape, mesh):
    """Run rank 0's share of ``cfg``'s step at ``shape`` on meta DTensors
    on ``mesh`` (a production mesh in a ``fake_world``) -> (counter,
    rules, the bytes of the inputs a rank holds)."""
    from repro_torch.analysis.op_cost import OpCounter
    from repro_torch.models import api
    from repro_torch.sharding import make_rules, use_rules
    rules = make_rules(mesh, cfg, shape)
    max_seq = shape.seq_len if cfg.family == "audio" else 0
    with use_rules(rules):
        batch = _meta_tree(rules, api.input_specs(cfg, shape),
                           api.input_axes(cfg, shape))
        if shape.kind == "train":
            st, ax = api.state_struct(cfg, max_seq), api.state_axes(cfg,
                                                                   max_seq)
            args = ({"params": _meta_tree(rules, st["params"],
                                          ax["params"]),
                     "opt": {"m": _meta_tree(rules, st["opt"]["m"],
                                             ax["opt"]["m"]),
                             "v": _meta_tree(rules, st["opt"]["v"],
                                             ax["opt"]["v"]),
                             "count": _meta_tree(
                                 rules, {"c": st["opt"]["count"]},
                                 {"c": ()})["c"]}}, batch)
            step = api.make_train_step(cfg)
        else:
            params = _meta_tree(rules, api.params_struct(cfg, max_seq),
                                api.params_axes(cfg, max_seq))
            if shape.kind == "prefill":
                args, step = (params, batch), api.make_prefill_step(cfg)
            else:
                cache = _meta_tree(rules, api.cache_specs(cfg, shape),
                                   api.cache_axes(cfg))
                # the write position of the last cache row
                batch["pos"] = shape.seq_len - 1
                args, step = (params, cache, batch), api.make_decode_step(cfg)
        held = _local_bytes(args)
        with OpCounter(mesh, live=True) as counter:
            step(*args)
    return counter, rules, held


def cut_depth(cfg, layers: int):
    """``cfg`` cut to ``layers`` layers (periods, for the hybrid family);
    as it is for 0."""
    if not layers:
        return cfg
    return cfg.with_overrides(n_layers=layers * (
        cfg.attn_period if cfg.family == "hybrid" else 1))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               layers: int = 0):
    """Lower one cell (an LM config cut to ``layers``, where given; the
    paper's model has no layers to cut). Returns (counter or None, row
    dict)."""
    if arch == "ivector-tvm":
        from repro_torch.launch import ivector_cell
        return ivector_cell.lower_cell(shape_name, multi_pod)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    from repro_torch.analysis.roofline import roofline_from_counts
    from repro_torch.launch import mesh as MS
    cfg = cut_depth(get_config(arch), layers)
    shape = get_shape(shape_name)
    mesh_tag = "multi" if multi_pod else "single"
    ok, why = cfg.shape_applicability(shape)
    if not ok:
        return None, {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                      "status": "skipped", "reason": why}
    t0 = time.perf_counter()
    with MS.fake_world(512 if multi_pod else 256):
        mesh = MS.make_production_mesh(multi_pod=multi_pod)
        counter, rules, held = lower_lm(cfg, shape, mesh)
    rep = roofline_from_counts(
        counter, arch=arch, shape=shape_name,
        mesh_desc="2x16x16" if multi_pod else "16x16", chips=mesh.size,
        model_flops=model_flops_estimate(cfg, shape),
        peak_memory=float(held + counter.peak_bytes),
        dtype=cfg.activation_dtype)
    row = rep.row()
    row["status"] = "ok"
    row["lower_seconds"] = time.perf_counter() - t0
    row["mesh_by_op"] = {k: list(v) for k, v in mesh.by_op.items()}
    row["kernels"] = {k: v[0] for k, v in counter.kernels.items()}
    row["fallbacks"] = sorted(set(str(f) for f in rules.fallbacks))
    if layers:
        row["layers"] = cfg.n_layers
    return counter, row


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             skip_existing: bool = True, out_dir: Path = OUT_DIR,
             layers: int = 0):
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_tag = "multi" if multi_pod else "single"
    cut = f"__L{layers}" if layers and arch != "ivector-tvm" else ""
    out = out_dir / f"{arch}__{shape_name}__{mesh_tag}{cut}.json"
    if skip_existing and out.exists():
        row = json.loads(out.read_text())
        if row.get("status") in ("ok", "skipped"):
            print(f"[cached] {arch} x {shape_name} x {mesh_tag}: "
                  f"{row.get('status')}")
            return row
    t0 = time.time()
    try:
        counter, row = lower_cell(arch, shape_name, multi_pod, layers)
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


def _cells(archs, shapes, meshes):
    return [(a, s, m) for a in archs for s in shapes for m in meshes]


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
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every LM config to this many layers")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells lowered at a time, each in its own process")
    args = ap.parse_args(argv)
    out_dir = OUT_DIR if args.out is None else Path(args.out)

    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]

    if args.all:
        cells = _cells(ARCH_IDS, [s.name for s in ALL_SHAPES], meshes)
    elif args.arch and args.shape:
        cells = _cells([args.arch], [args.shape], meshes)
    else:
        ap.error("--arch/--shape or --all required")
    kw = dict(skip_existing=not args.force, out_dir=out_dir,
              layers=args.layers)
    if args.jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(args.jobs,
                                 mp_context=mp.get_context("spawn")) as ex:
            rows = list(ex.map(functools.partial(_run_one, **kw), cells))
    else:
        rows = [_run_one(c, **kw) for c in cells]
    n_bad = sum(r.get("status") == "error" for r in rows)
    if args.all:
        print(f"done; {n_bad} errors")
        raise SystemExit(1 if n_bad else 0)


def _run_one(cell, **kw):
    return run_cell(*cell, **kw)


if __name__ == "__main__":
    main()
