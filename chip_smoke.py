#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--requests 64]

Run from the root of a checkout. It builds the hand-written kernels from
``src/repro_torch/csrc``, holds each kernel against its plain PyTorch
version at the shapes of the serving path and times both, then serves
ragged requests through ``IVectorExtractor`` at the paper's full width
(D=72, C=2048, R=400, K=20) on a synthetic, well-conditioned UBM and TVM
made from ``--seed``: first on the default sparse rung, then on the dense
rung, and checks the i-vectors against the same path run on the CPU with
the plain versions. Every phase that fails exits non-zero.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is one JSON object with every kernel's numbers. The
same numbers are written to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): f32 on the CUDA cores, bf16 on the
# tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12

# |kernel - plain| <= TOL * max|plain|: both sum f32 products of the same
# inputs, in another order (reductions of 5256, 2048 or 512 terms)
TOL = 2e-5
# served i-vectors are unit vectors; sparse and dense rungs, and the card
# and the CPU, differ only by f32 rounding of the same statistics
IVEC_TOL = 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after warm-up."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str = "float32"):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for the operands' type."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def compare(name, got, want):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = err <= TOL * scale
    print(f"  {name}: max_abs_err {err:.3e}  max_rel_err "
          f"{err / scale:.3e}  (tolerance {TOL:g} x max|plain| = "
          f"{TOL * scale:.3e})  {'ok' if ok else 'DISAGREES'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def synthetic_system(cfg, seed: int, dev):
    """A well-conditioned full-width UBM (SPD covariances) and TVM
    (``init_model``, prior offset from the config), from ``seed``. The
    components overlap as a speech UBM's do: about four of a frame's 20
    preselected components keep a posterior above the 0.025 floor, so the
    sparse and dense rungs are compared on soft alignments."""
    from repro_torch.core import tvm as TV
    from repro_torch.core import ubm as U
    C, D, R = cfg.n_components, cfg.feat_dim, cfg.ivector_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand(C, generator=g, device=dev) + 0.5
    means = 0.5 * torch.randn(C, D, generator=g, device=dev)
    A = torch.randn(C, D, D, generator=g, device=dev)
    eye = torch.eye(D, device=dev)
    covs = 0.3 * A @ A.transpose(1, 2) / D + eye
    ubm = U.FullGMM(w / w.sum(), means, covs)
    model = TV.init_model(g, means, covs, R, cfg.formulation,
                          prior_offset=cfg.prior_offset)
    return ubm, model, g


def synthetic_requests(ubm, n: int, seed: int, g):
    """``n`` ragged utterances of 256-2048 frames drawn from the UBM, each
    with its own offset (a stand-in for speaker and channel)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(256, 2049, size=n)
    chol = torch.linalg.cholesky(ubm.covs)
    D = ubm.means.shape[1]
    dev = ubm.means.device
    utts = []
    for L in lengths.tolist():
        comp = torch.multinomial(ubm.weights, L, replacement=True,
                                 generator=g)
        z = torch.randn(L, D, 1, generator=g, device=dev)
        shift = 0.2 * torch.randn(D, generator=g, device=dev)
        x = ubm.means[comp] + (chol[comp] @ z)[..., 0] + shift
        utts.append(x.cpu().numpy())
    return utts


def kernel_checks(ex, utts, g):
    """Each kernel against its plain version at the serving path's shapes:
    error, kernel time, plain time, bound and library time."""
    from repro_torch.core import alignment as AL
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import gmm_rescore as GR
    from repro_torch.kernels import ref
    from repro_torch.kernels import tvm_estep as TE
    dev = ex.device
    const, lin, P = ex._pack.pre
    C, D = lin.shape
    K = ex.cfg.posterior_top_k
    frames = torch.from_numpy(np.concatenate(utts)).to(dev)
    rows = []

    # gmm_loglik: F=4096, C=2048, D=72
    x = frames[:4096].contiguous()
    linT, Pf = lin.T.contiguous(), P.reshape(C, D * D).contiguous()
    got = GL.gmm_loglik(x, const, linT, Pf)
    want = ref.gmm_loglik(x, const, linT, Pf)
    err = compare("gmm_loglik [4096x72] x C=2048", got, want)
    F = x.shape[0]
    b_ms, b_by = bound(2.0 * F * C * (D * D + D),
                       4.0 * (F * D + C + D * C + C * D * D + F * C))
    rows.append(dict(
        name="gmm_loglik", route="cuda",
        source="src/repro_torch/csrc/gmm_loglik.cu",
        replaces="src/repro/kernels/gmm_loglik.py:49", max_abs_err=err,
        ms=cuda_ms(lambda: GL.gmm_loglik(x, const, linT, Pf), 20),
        plain_ms=cuda_ms(lambda: ref.gmm_loglik(x, const, linT, Pf), 20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del got, want

    # gmm_rescore: F=16384, K=20, ids from the real diag preselection
    x = frames[:16384].contiguous()
    F = x.shape[0]
    _, sel = AL.preselect(ex._pack.diag, x, K)
    sel = sel.contiguous()
    A = ex._pack.rescore_A
    got = GR.gmm_rescore(x, sel, A)
    want = ref.gmm_rescore(x, sel, const, linT, Pf)
    err = compare(f"gmm_rescore [{F}x{K}] of C=2048", got, want)
    rows_touched = torch.unique(sel).numel()
    b_ms, b_by = bound(2.0 * F * K * (D * D + D + 1),
                       4.0 * (F * D + rows_touched * A.shape[1] + F * K)
                       + 8.0 * F * K)
    rows.append(dict(
        name="gmm_rescore", route="cuda",
        source="src/repro_torch/csrc/gmm_rescore.cu",
        replaces="src/repro/kernels/gmm_rescore.py:129", max_abs_err=err,
        ms=cuda_ms(lambda: GR.gmm_rescore(x, sel, A), 20),
        plain_ms=cuda_ms(
            lambda: ref.gmm_rescore(x, sel, const, linT, Pf), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del got, want
    torch.cuda.empty_cache()

    # tvm_estep_l: [16, 2048] @ [2048, 80200], the precompute of the session
    Up = ex._tv_pre.U
    Pn = Up.shape[1]
    n16 = 50.0 * torch.rand(16, C, generator=g, device=dev)
    got = TE.tvm_estep_l(n16, Up)
    want = ref.tvm_estep_l(n16, Up)
    err = compare(f"tvm_estep_l [16x{C}] @ [{C}x{Pn}]", got, want)
    b_ms, b_by = bound(2.0 * 16 * C * Pn, 4.0 * (16 * C + C * Pn + 16 * Pn))
    rows.append(dict(
        name="tvm_estep_l", route="cuda",
        source="src/repro_torch/csrc/packed_matmul.cu",
        replaces="src/repro/kernels/tvm_estep.py:63", max_abs_err=err,
        ms=cuda_ms(lambda: TE.tvm_estep_l(n16, Up), 20),
        plain_ms=cuda_ms(lambda: ref.tvm_estep_l(n16, Up), 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.matmul(n16, Up), 20)))
    del got, want

    # tvm_estep_a: [512, 2048]^T @ [512, 80200], f32 and bf16 inputs
    n512 = 50.0 * torch.rand(512, C, generator=g, device=dev)
    PP = torch.randn(512, Pn, generator=g, device=dev)
    for dtype, tag in ((torch.float32, "float32"),
                       (torch.bfloat16, "bfloat16")):
        a, b = n512.to(dtype), PP.to(dtype)
        got = TE.tvm_estep_a(a, b)
        want = ref.tvm_estep_a(a, b)
        name = "tvm_estep_a" + ("" if tag == "float32" else "_bf16")
        err = compare(f"{name} [512x{C}]^T @ [512x{Pn}]", got, want)
        esz = a.element_size()
        b_ms, b_by = bound(2.0 * C * 512 * Pn,
                           esz * (512 * C + 512 * Pn) + 4.0 * C * Pn, tag)
        if tag == "float32":
            lib = cuda_ms(lambda: torch.matmul(a.T, b), 10)
        else:
            lib = cuda_ms(lambda: torch.mm(a.T, b, out_dtype=torch.float32),
                          10)
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/packed_matmul.cu",
            replaces="src/repro/kernels/tvm_estep.py:63", max_abs_err=err,
            ms=cuda_ms(lambda: TE.tvm_estep_a(a, b), 10),
            plain_ms=cuda_ms(lambda: ref.tvm_estep_a(a, b), 10),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib))
        del got, want
    del PP, n512
    torch.cuda.empty_cache()
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  library {r['library_ms']}")
    return rows


def counters():
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import gmm_rescore as GR
    from repro_torch.kernels import tvm_estep as TE
    return {"gmm_loglik": GL.gmm_loglik, "gmm_rescore": GR.gmm_rescore,
            "tvm_estep_l": TE.tvm_estep_l, "tvm_estep_a": TE.tvm_estep_a}


def drive(ex, utts, label: str):
    """Serve ``utts`` once with every launch count set to 0 just before;
    returns (i-vectors, launches by kernel, wall seconds)."""
    for w in counters().values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iv = ex.extract(utts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters().items()}
    frames = sum(u.shape[0] for u in utts)
    audio_s = frames / 100.0      # 10 ms frame shift
    print(f"  {label}: {len(utts)} requests, {frames} frames in "
          f"{wall:.3f} s: {len(utts) / wall:.1f} utts/s, real-time factor "
          f"{wall / audio_s:.2e} ({audio_s / wall:.0f}x real time); "
          f"launches {launches}")
    return iv, launches, wall


def profile_path(ex, utts):
    """One sparse pass under ``torch.profiler``: its wall time (inflated by
    the profiler), the device's busy time (the sum of device-side events,
    kernels and copies, all on one stream) and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.extract(utts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    top = sorted(((k, ms, c) for k, (ms, c) in by_name.items()),
                 key=lambda t: -t[1])
    return {"wall_ms": wall_ms, "device_ms": sum(t[1] for t in top),
            "top": top[:15]}


def check_ivectors(iv, n: int, R: int, label: str) -> None:
    if iv.shape != (n, R) or not np.isfinite(iv).all():
        fail(f"{label}: i-vectors not finite of shape {(n, R)}")
    norms = np.linalg.norm(iv, axis=1)
    if np.abs(norms - 1.0).max() > 1e-4:
        fail(f"{label}: i-vectors not unit-norm ({norms.min()}, "
             f"{norms.max()})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.ivector_tvm import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.serving import IVectorExtractor, ServingConfig

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print("[1] card")
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), {kind}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[2] build: {len(_build.SIGNATURES)} kernel libraries in "
          f"{build_s:.1f} s")

    # 3. model, session and kernel checks at the serving path's shapes
    dev = torch.device("cuda")
    cfg = CONFIG
    ubm, model, g = synthetic_system(cfg, args.seed, dev)
    t0 = time.perf_counter()
    ex = IVectorExtractor(cfg, model, ubm, ServingConfig(), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"[3] session set-up (UBM pack + TVM precompute, D={cfg.feat_dim}"
          f" C={cfg.n_components} R={cfg.ivector_dim}): {setup_s:.2f} s")
    utts = synthetic_requests(ubm, args.requests, args.seed, g)
    rows = kernel_checks(ex, utts, g)

    # 4. main path: sparse rung, then dense rung
    print("[4] main path")
    health = ex.health_check()
    if not health["ok"]:
        fail(f"health check: {health}")
    iv, launches_sparse, wall = drive(ex, utts, "sparse")
    check_ivectors(iv, len(utts), cfg.ivector_dim, "sparse")
    if ex.mode != "sparse" or ex.stats["degradations"] != 0:
        fail(f"session left the sparse rung: {ex.stats}")
    for k in ("gmm_rescore", "tvm_estep_l"):
        if launches_sparse[k] == 0:
            fail(f"sparse path never launched {k}")
    iv2, _, wall2 = drive(ex, utts, "sparse, again")
    if not np.array_equal(iv, iv2):
        fail("the same requests served twice are not bitwise equal")
    print("  repeat run is bitwise equal")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_path(ex, utts)
    print(f"  profiled sparse pass: wall {profile['wall_ms']:.1f} ms, device "
          f"busy {profile['device_ms']:.1f} ms "
          f"({100 * profile['device_ms'] / profile['wall_ms']:.0f}%); top "
          "device time by kernel (ms):")
    for name, ms, calls in profile["top"][:8]:
        print(f"    {ms:9.3f}  x{calls:<5d} {name[:90]}")
    del ex
    torch.cuda.empty_cache()

    ex_d = IVectorExtractor(cfg.with_overrides(rescore="dense"), model, ubm,
                            ServingConfig(), device=dev)
    iv_d, launches_dense, wall_d = drive(ex_d, utts, "dense")
    check_ivectors(iv_d, len(utts), cfg.ivector_dim, "dense")
    if ex_d.mode != "dense" or ex_d.stats["degradations"] != 0:
        fail(f"dense session degraded: {ex_d.stats}")
    for k in ("gmm_loglik", "tvm_estep_l"):
        if launches_dense[k] == 0:
            fail(f"dense path never launched {k}")
    d_sd = float(np.abs(iv - iv_d).max())
    print(f"  sparse vs dense: max |diff| {d_sd:.3e} (tolerance {IVEC_TOL})")
    if d_sd > IVEC_TOL:
        fail("sparse and dense rungs disagree")
    del ex_d
    torch.cuda.empty_cache()

    # reference: the shortest requests through the same path on the CPU,
    # on the plain versions (max_batch 4 keeps the CPU gathers small)
    pick = np.argsort([u.shape[0] for u in utts])[:4]
    ex_c = IVectorExtractor(cfg, model.to("cpu"), ubm.to("cpu"),
                            ServingConfig(max_batch=4), device="cpu")
    iv_c = ex_c.extract([utts[i] for i in pick])
    d_cpu = float(np.abs(iv[pick] - iv_c).max())
    print(f"  card vs CPU plain path on {len(pick)} requests: max |diff| "
          f"{d_cpu:.3e} (tolerance {IVEC_TOL})")
    if d_cpu > IVEC_TOL:
        fail("card and CPU plain path disagree")

    # 5. kernels line, card line, contract line
    # tvm_estep_a (and its bf16 form) is the training contraction: held
    # and timed here, off the serving path, so its launches stay 0
    on_path = {"gmm_loglik", "gmm_rescore", "tvm_estep_l"}
    for r in rows:
        r["launches"] = (launches_sparse.get(r["name"], 0)
                         + launches_dense.get(r["name"], 0))
        r["on_path"] = r["name"] in on_path
    frames = sum(u.shape[0] for u in utts)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed,
              "build_s": build_s, "setup_s": setup_s,
              "requests": len(utts), "frames": frames,
              "sparse_wall_s": [wall, wall2], "dense_wall_s": wall_d,
              "launches": {"sparse": launches_sparse,
                           "dense": launches_dense},
              "peak_mem_gb_sparse": peak_gb, "profile_sparse": profile,
              "sparse_vs_dense_max_diff": d_sd,
              "card_vs_cpu_max_diff": d_cpu, "kernels": rows}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "on_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
