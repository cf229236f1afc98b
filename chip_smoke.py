#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--requests 64]

Run from the root of a checkout. It builds the hand-written kernels from
``src/repro_torch/csrc``, holds each kernel against its plain PyTorch
version at the shapes of the serving and training paths and times both,
then, at the paper's full width (D=72, C=2048, R=400, K=20) on a
synthetic, well-conditioned UBM and TVM made from ``--seed``:

* serves ragged requests through ``IVectorExtractor`` on the default
  sparse rung, then on the dense and fused rungs, and checks the
  i-vectors against the same path run on the CPU with the plain versions;
* trains on synthetic frames drawn from that UBM (640 utterances x 512
  frames): ``ubm.train_ubm``, then ``trainer.train`` for 3 iterations on
  ``CONFIG`` (statistics once, then EM) and for 3 fused iterations with
  realignment and the full UBM refresh, twice (bitwise repeatable), then
  ``trainer.extract``; and checks one iteration on three corpora of 64
  utterances against the CPU plain path on quantities the eigenvector
  signs of ``min_divergence`` leave alone;
* on the LM side, holds ``flash_attention`` and ``selective_scan`` against
  their plain versions at Jamba's and StableLM's shapes (the scan also at
  d_state 8, and each d_state instance at ragged widths), then runs at
  the published widths in bf16 with random params from ``--seed``:
  StableLM-2 1.6B served through ``repro_torch.launch.serve`` (batch 8,
  prompt 1024, 32 tokens) and Jamba v0.1 without its experts (32 layers;
  prefill of 4 x 2048 tokens, then 16 decode steps from a zero cache, as
  its prefill returns no cache); and checks, at
  depth 8 in f32, Jamba's prefill on the kernels against the same path on
  the plain versions, and decode against prefill for both models; then
  the rest of the zoo at its published widths in bf16, each freed before
  the next: Phi-3-medium 14B, Nemotron-4 15B, Gemma 2B (the attention at
  head dim 256) and RWKV-6 7B through ``repro_torch.launch.serve`` (batch
  4, prompt 1024, 16 tokens), Whisper large-v3 (1,500 frames, 448 decoder
  tokens) and InternVL2-1B (256 patches + 768 text tokens) through the
  ``models.api`` steps with 16 decode steps; and at full width, 2 to 4
  layers, in f32, each one's prefill on the kernels against the plain
  versions and decode against prefill; then the archs with experts in
  bf16: Moonlight 16B-A3B at full depth and Arctic 480B at 2 layers
  through ``repro_torch.launch.serve`` (batch 4, prompt 1024, 16 tokens)
  and Jamba v0.1 with its experts at one period (as Jamba above); and
  Moonlight at 2 layers in f32 (kernels against plain versions, decode
  against prefill at capacity factor 64), the three at SMOKE card against
  CPU;
* drives the staged recipe (``repro_torch.api``) at full width: 64
  speakers x 10 utterances x 512 frames from the port's
  ``data/speech.py`` (mean and variance normalised), a top-20
  ``train_ubm`` UBM passed in through the (feats, labels, ubm) triple,
  ``IVectorRecipe.run`` for 3 iterations with the §4.1 backend, the trial
  EER and a bundle saved to a temporary directory; serves 32 requests
  through ``IVectorExtractor.from_bundle`` (bitwise the in-memory
  session's) and holds the backend against the CPU;
* streams, on the phase-3 system saved as a bundle and served through
  ``from_bundle``, 32 of its requests (480 frames each) in 40-frame
  chunks through ``AdmissionQueue`` and a journaled ``SessionStore``, and
  checks the streamed i-vectors against batch extraction, an in-process
  crash restore and a torn journal tail (bitwise), a real ``kill -9`` of a
  child serving the same streams (this script with a private flag), the
  fused -> sparse -> dense demotion ladder, the gated rollout (identical
  bundle, a new one with migrate, rollback and drain, a byte-flipped one)
  and the admission counters; holds the session path's kernels at its
  chunk shapes;
* trains with ``trainer.train_supervised`` on 128 utterances x 512 frames
  (3 macro-steps, bitwise ``trainer.train``), then with a NaN batch, two
  host losses and a corrupted checkpoint injected, which must end bitwise
  at the same model;
* runs the mesh mode (``launch/mesh.py``, ``launch/ivector_cell.py``) on
  256 utterances x 512 frames drawn from the phase-3 UBM: the kernels at
  a model-sharded rank's shapes (C_loc = 1,024), one-rank references in
  this process, then worlds of 2 and 4 ranks spawned on the one card over
  gloo with the (2, 1), (1, 2), (4, 1) and (2, 2) meshes: trajectories
  bitwise the one-rank run on the data meshes, per-utterance n/f bitwise
  on all, T T^T and Sigma within the JAX tests' tolerances on the
  model-sharded ones, the psum exit, the three rungs, macro-batches
  through prefetch, and every kernel of the path on every rank. Several
  ranks share one card there, so its times check the path and the cost
  of its collectives; they do not measure scaling.
* runs the port's ``analysis/``: the kernel registry's shared memory at
  the main paths' shapes against the card's opt-in limit and the CUDA
  side's geometry, each kernel's time against its bound (every bound
  above comes from ``kernels/registry.py``'s work), ``autotune_align``'s
  prediction against the measured ``gmm_align`` (K = 20 and 40, and the
  rescore alone), ``op_cost`` on one iteration counted on the card and on
  the CPU (equal flops), a full-width iteration's ``RooflineReport`` row,
  and the check gate with its dispatch pass on the card (no finding);
* lowers without a cluster (``launch/dryrun.py``): ``ivector-tvm x
  train_4k`` on the 16 x 16 and 2 x 16 x 16 production meshes, rank 0's
  share on meta tensors in a fake world of 256 and 512 ranks, held to the
  digits ``tests/test_torch_dryrun.py`` pins on the CPU; an
  ``em_macro_step`` of 128 x 1024 frames on the card against the same call
  lowered (flops, bytes, and the lowered peak beside the card's); and the
  (2, 2) mesh lowered in a fake world of 4 against the collective bytes
  the gloo ranks above counted;
* trains the LM zoo (phase 13): both backward kernels against autograd
  of their plain versions; one SMOKE train step card against CPU for
  StableLM, Jamba without and with experts, Moonlight, Arctic, RWKV-6,
  Whisper and InternVL2; bf16 steps of 4 x 4096 tokens at full width:
  StableLM-2 1.6B, Jamba (one period, no experts), Gemma 2B, Moonlight
  (4 layers), RWKV-6 (4 layers, grad_accum 4), Whisper large-v3 (1,500
  frames, 448 decoder tokens) and InternVL2-1B (256 patches + 3,840
  tokens), most with a step repeated bitwise; the supervised restart
  drill and ``launch.train.main``;
* runs the LM side's mesh paths (phase 14) on worlds of 4 and 2 ranks
  over gloo on the one card: every LM arch's SMOKE gradients on (2, 2)
  against one rank, InternVL2-1B on (1, 4) through the ring, Moonlight
  on (2, 2) through ``moe_a2a``, each with an f32 step (its loss, grad
  norm, params and gradients) held to one rank, Jamba with experts (one
  period) prefilling on (2, 2) against one rank in f32 activations and,
  at its first MoE layer, in bf16, StableLM-2 steps (4 layers on (2, 2),
  2 on (1, 2)) whose collectives by op equal their lowering in a fake
  world, the elastic restore (4, 1) ->
  (2, 2) and (2, 1), and one LM dry-run row per production mesh equal to
  ``tests/test_torch_mesh_lm.py``'s ``LM_PINS``;
* lifts the i-vector side's refusals (phase 16): each wrapper's geometry
  against the CUDA side's for every D up to 512; the new forms at the old
  limits against their plain versions (``gmm_align``'s spill form at C =
  6273, 8192 and 65,536 with K = 33, 64 and C, its wide phase B at D =
  235, 256, 512; ``gmm_rescore`` at D = 201, 256, 512 and C = 65,536;
  ``gmm_loglik``'s rows form on the tensor cores at D = 205 to 512 and
  its packing kernel; ``bw_stats``' pairs form at D = 255, 256, 512; each
  twice, bitwise equal), the sums over E2 or D^2 held to their formula in
  float64; the path at
  D = 256 (``train_ubm``, the rungs' statistics, the statistics pass, 2
  EM iterations repeated bitwise, extraction, 32 requests on every rung,
  card against CPU at C = 64) and ``train_ubm`` at C = 8192 with
  ``top_k=0``. ``--phase 16`` runs it alone after the card and build
  steps;
* lifts the LM side's last refusals (phase 17): each attention wrapper's
  launch geometry against the CUDA side's at every head dim 1 to 512 in
  both types, the scan's at every d_state 1 to 256; attention at 14
  head dims in f32 and bf16 and the scan at 6 d_states past 64 in its
  three forms, forward and backward, against their plain versions,
  timed beside SDPA and the bound; Jamba one period served at d_state
  256 and trained at 128, StableLM-2 8 layers served at head_dim 72 and
  320 and trained at 320, Whisper 2 + 2 layers at head_dim 81, all at
  full width, and SMOKE configs at the new shapes card against CPU (f32
  train steps on the CUDA-core kernels at head_dim 320 and 33 among
  them).
  ``--phase 17`` runs it alone after the card and build steps.

``--rows SRC`` times only the kernels' existing rows (``ROWS``: the LM
kernels' and the i-vector kernels') with the package under SRC, for a
parent against a change on one card, and SDPA in f32 beside them.
``--probe`` splits the f32 attention kernels' time into their parts
(``PROBE_VARIANTS``) beside an f32 SGEMM; ``--probe-ivector SRC`` splits
gmm_loglik's and bw_stats' wide forms' (``PROBE_IVEC_VARIANTS``).

Every phase that fails exits non-zero. It takes a few minutes on an H100.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
before it come the card's name and power limit, and before that one JSON
object with every kernel's numbers. The same numbers are written to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import re
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()

# exponentials a clock on one SM (the MUFU unit)
MUFU_PER_SM_CLOCK = 16

# |kernel - plain| <= TOL * max|plain|: both sum f32 products of the same
# inputs, in another order (reductions of 5256, 2048 or 512 terms)
TOL = 2e-5
# served i-vectors are unit vectors; sparse, dense and fused rungs, and the
# card and the CPU, differ only by f32 rounding of the same statistics
IVEC_TOL = 1e-3
# gmm_align scores its diag preselection inside the kernel: a frame whose
# K-th and (K+1)-th scores differ by less than f32 rounding may select
# another set than the plain version's matmul; at least this share agrees
ALIGN_AGREE = 0.999
# training, card against the CPU plain path after one iteration, on
# CPU_CHECK_RUNS corpora. The alignment: POST_AGREE of the frames select
# the same components with posteriors within POST_TOL (f32 scores summed
# in another order move a posterior by under 3e-4). The EM iteration, from
# the same statistics: each invariant to its limit x its largest |value|.
# Sigma and the diagnostics are well posed (INV_TOL: f32 sums in another
# order). T_c T_c^T, T[:,:,0] p and |prior| are not: at 64 x 256 frames
# each component's A_c sums the i-vector moments of a few dozen utterances
# against R = 400, and |prior| = sqrt(h^T G^-1 h) goes through the
# i-vectors' covariance G, whose offset direction barely varies; f32
# rounding reaches them through those solves. They are held to T_INV_TOL,
# about eight times the largest reading over three corpora (1.3e-3 of
# |prior|, NVIDIA H100 80GB HBM3, 700 W).
POST_TOL = 1e-3
POST_AGREE = 0.999
INV_TOL = 1e-3
T_INV_TOL = 1e-2
ILL_POSED = ("T_c T_c^T", "T[:,:,0] p", "|prior|")
CPU_CHECK_RUNS = 3
# the recipe phase: 64 speakers x 10 utterances x 512 frames
RECIPE_SPEAKERS, RECIPE_UTTS, RECIPE_FRAMES = 64, 10, 512
# the §4.1 backend of the recipe run, card against the CPU. One trained
# backend applied and scored on both: projected vectors and trial scores
# within BACKEND_TOL x max|value| (f32 products and two Cholesky solves of
# the same inputs, in another order; 3.7e-7 and 1.9e-6 read on an H100
# 80GB HBM3, 700 W). The chain trained anew on the CPU from the card's
# i-vectors: LDA 400 -> 200 on 64 speakers keeps 137 columns from the null
# space of the between-class scatter (rank 63), chosen by rounding, so
# only the 63 leading projected columns are held, up to sign, within
# LDA_LEAD_TOL x max|value| (read: 4.7e-7), and its EER within EER_TOL,
# five trials of the 10,000 in a class (read: equal); its trial scores
# are printed (read: 5.3e-3 x max|score| apart).
BACKEND_TOL = 1e-4
LDA_LEAD_TOL = 1e-4
EER_TOL = 5e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def ptxas_report(names, key: str) -> dict:
    """{mangled kernel name containing ``key``: its ptxas lines after the
    entry line (stack frame and spills, registers), joined by '; ', with
    "C7512" added where ptxas serialized the kernel's wgmma} from the build
    logs of ``csrc/<name>.cu`` for each name (``_build.build_log``: the
    library build runs ptxas with -v). Any other C7512 line is printed."""
    from repro_torch.kernels import _build
    entry = re.compile(r"Compiling entry function '([^']+)'")
    serial = re.compile(r"\(C7512\).*'([^']+)'")
    out, serialized = {}, []
    for n in names:
        name = None
        for line in _build.build_log(n).read_text().splitlines():
            m = entry.search(line)
            if "C7512" in line:
                serialized.append(line.strip())
            if m:
                name = m.group(1) if key in m.group(1) else None
                if name is not None:
                    out[name] = []
            elif name is not None and ("spill" in line or "Used" in line):
                out[name].append(line.split(":", 1)[-1].strip()
                                 if line.startswith("ptxas") else line.strip())
    for line in serialized:
        m = serial.search(line)
        if m and m.group(1) in out:
            out[m.group(1)].append("C7512 (wgmma serialized)")
        else:
            print(f"  ptxas: {line}")
    return {k: "; ".join(v) for k, v in out.items()}


def res_usage(names) -> dict:
    """{mangled kernel name: "REG n, STACK m"} of every kernel in the built
    libraries of ``csrc/<name>.cu`` for each name, from ``cuobjdump
    -res-usage`` (no second compile: a stack frame above 0 is a spill or a
    local array)."""
    from repro_torch.kernels import _build
    tool = str(Path(_build._nvcc()).parent / "cuobjdump")
    fn = re.compile(r"Function ([^:\s]+):")
    res = re.compile(r"REG:(\d+) STACK:(\d+)")
    out = {}
    for n in names:
        log = subprocess.run([tool, "-res-usage",
                              str(_build.library_path(n))],
                             capture_output=True, text=True, check=True).stdout
        name = None
        for line in log.splitlines():
            m = fn.search(line)
            if m:
                name = m.group(1)
            r = res.search(line)
            if r and name is not None:
                out[name] = f"REG {r.group(1)}, STACK {r.group(2)}"
                name = None
    return out


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


@functools.lru_cache(maxsize=1)
def mufu_rate():
    """(exponentials a second, how it is made up): MUFU_PER_SM_CLOCK times
    the SMs times the card's max SM clock from nvidia-smi."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return (MUFU_PER_SM_CLOCK * n_sm * mhz * 1e6,
            f"{MUFU_PER_SM_CLOCK} a clock an SM x {n_sm} SMs x {mhz:.0f} MHz")


def bound(kernel: str, **cfg):
    """(bound_ms, bound_by) of one call of a registered kernel at these
    shapes: its work from ``kernels/registry.py`` against the H100's
    data-sheet peaks in ``analysis/roofline.py`` (the larger of bytes over
    the memory rate and operations over the peak rate for the operands'
    type)."""
    from repro_torch.analysis import roofline
    return roofline.kernel_bound(kernel, cfg)


def compare(name, got, want, tol=TOL):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    ok = err <= tol * scale
    print(f"  {name}: max_abs_err {err:.3e}  max_rel_err "
          f"{err / scale:.3e}  (tolerance {tol:g} x max|plain| = "
          f"{tol * scale:.3e})  {'ok' if ok else 'DISAGREES'}")
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
    dev = ex.device
    const, lin, P = ex._pack.pre
    C, D = lin.shape
    K = ex.cfg.posterior_top_k
    frames = torch.from_numpy(np.concatenate(utts)).to(dev)
    rows = []

    # gmm_loglik: F=4096, C=2048, D=72, then a ragged F and C and a P with
    # an antisymmetric part (the kernel works on the symmetric part)
    x = frames[:4096].contiguous()
    linT, Pf = lin.T.contiguous(), P.reshape(C, D * D).contiguous()
    got = GL.gmm_loglik(x, const, linT, Pf)
    want = ref.gmm_loglik(x, const, linT, Pf)
    err = compare("gmm_loglik [4096x72] x C=2048", got, want)
    Fr, Cr = 1000, 2000
    compare(f"gmm_loglik ragged [{Fr}x72] x the first {Cr} components",
            GL.gmm_loglik(x[:Fr].contiguous(), const[:Cr].contiguous(),
                          linT[:, :Cr].contiguous(), Pf[:Cr].contiguous()),
            ref.gmm_loglik(x[:Fr], const[:Cr], linT[:, :Cr], Pf[:Cr]))
    # a generator of its own, so the draws of later phases stay as they were
    g2 = torch.Generator(device=dev).manual_seed(g.initial_seed() + 1)
    skew = torch.randn(C, D, D, generator=g2, device=dev)
    Pn = (P + 1e-3 * P.abs().max() * (skew - skew.transpose(1, 2))
          ).reshape(C, D * D).contiguous()
    compare("gmm_loglik [4096x72] x C=2048, P not symmetric",
            GL.gmm_loglik(x, const, linT, Pn),
            ref.gmm_loglik(x, const, linT, Pn))
    del skew, Pn
    F = x.shape[0]
    E2 = 1 + D + D * (D + 1) // 2
    b_ms, b_by = bound("gmm_loglik", F=F, C=C, D=D)
    # library yardsticks, operands built beforehand: one torch.addmm over
    # the packed expansion (ref.expand_quadratic without its ones column)
    # and the packed weights, const as the bias; and, for continuity with
    # earlier runs, over the full-width [x | vec(xxᵀ)] and [lin; -½ P_flatᵀ]
    xp = ref.expand_quadratic(x)[:, 1:].contiguous()
    wp = GL.packed_weights(const, linT, Pf)[1:E2, :C].contiguous()
    compare("torch.addmm yardstick of gmm_loglik, packed",
            torch.addmm(const, xp, wp), want)
    xe = torch.cat([x, (x[:, :, None] * x[:, None, :]).reshape(F, D * D)],
                   dim=1)
    we = torch.cat([linT, -0.5 * Pf.T], dim=0).contiguous()
    compare("torch.addmm yardstick of gmm_loglik, full width",
            torch.addmm(const, xe, we), want)
    rows.append(dict(
        name="gmm_loglik", route="cuda",
        source="src/repro_torch/csrc/gmm_loglik.cu",
        replaces="src/repro/kernels/gmm_loglik.py:49", max_abs_err=err,
        ms=cuda_ms(lambda: GL.gmm_loglik(x, const, linT, Pf), 20),
        plain_ms=cuda_ms(lambda: ref.gmm_loglik(x, const, linT, Pf), 20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.addmm(const, xp, wp), 20),
        library_full_ms=cuda_ms(lambda: torch.addmm(const, xe, we), 20),
        pack_ms=cuda_ms(lambda: GL.packed_weights(const, linT, Pf), 20)))
    del got, want, xe, we, xp, wp

    # gmm_rescore: F=16384, K=20, ids from the real diag preselection
    x = frames[:16384].contiguous()
    F = x.shape[0]
    _, sel = AL.preselect(ex._pack.diag, x, K)
    sel = sel.contiguous()
    A = ex._pack.rescore_A
    got = GR.gmm_rescore(x, sel, A)
    want = ref.gmm_rescore(x, sel, const, linT, Pf)
    err = compare(f"gmm_rescore [{F}x{K}] of C=2048", got, want)
    b_ms, b_by = bound("gmm_rescore", F=F, K=K, C=C, D=D,
                       rows_touched=torch.unique(sel).numel())
    rows.append(dict(
        name="gmm_rescore", route="cuda",
        source="src/repro_torch/csrc/gmm_rescore.cu",
        replaces="src/repro/kernels/gmm_rescore.py:129", max_abs_err=err,
        ms=cuda_ms(lambda: GR.gmm_rescore(x, sel, A), 20),
        plain_ms=cuda_ms(
            lambda: ref.gmm_rescore(x, sel, const, linT, Pf), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del got, want
    rows[-1].update(check_gmm_rescore(ex, frames, x, sel, K, g))
    torch.cuda.empty_cache()

    rows += check_packed_matmul(ex, C, g)
    rows.append(check_bw_stats(ex, frames, K, g))
    rows.append(check_gmm_align(ex, frames, K))
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  library {r['library_ms']}")
    print(f"  gmm_loglik: of its kernel time, the packing pass "
          f"{rows[0]['pack_ms']:.4f} ms; full-width torch.addmm "
          f"{rows[0]['library_full_ms']:.4f} ms")
    bw = next(r for r in rows if r["name"] == "bw_stats")
    print(f"  bw_stats: frame runs {bw['splits']}; full-width "
          f"torch.matmul {bw['library_full_ms']:.4f} ms; bound over the "
          f"touched (frame, tile) pairs {bw['touched_bound_ms']:.4f} ms")
    return rows


def short_name(kernel: str) -> str:
    """A device event's name without its return type, namespace and
    argument list."""
    return (kernel.replace("(anonymous namespace)::", "")
            .replace("void ", "").split("(")[0])


def pair_spread(sel, C: int):
    """How a launch's (frame, slot) pairs spread over the components: the
    distinct ids, the mean (over those ids) and the largest number of pairs
    a component has, and for each work-item size BP the share of the
    BP-pair slots that grouping the pairs by component fills."""
    counts = torch.bincount(sel.reshape(-1), minlength=C)
    used = counts[counts > 0]
    n = sel.numel()
    fill = {bp: n / (bp * ((used + bp - 1) // bp).sum().item())
            for bp in (32, 64)}
    return {"distinct": used.numel(), "mean": n / used.numel(),
            "max": used.max().item(), "fill": fill}


def check_gmm_rescore(ex, frames, x, sel, K: int, g):
    """gmm_rescore beyond the timed shape: ragged F (1,000), C = 1999 (the
    first 1,999 rows, ids clipped into them), K = 1 and K = 40, every frame
    on one set of ids (a serving bucket's padded frames), a P that is not
    symmetric, D = 36 and 7 (the kernel's instance for any D, on random
    SPD precisions), and the stats pass's F = 262,144 (the request frames
    repeated; the plain version in 16,384-frame pieces), each held against
    ``ref.gmm_rescore``; two calls bitwise equal. Prints how the pairs
    spread over the components (``pair_spread``), the time at both F and
    its split by launch (profiled), and holds the wrapper's ``geometry``
    against the CUDA side's."""
    from repro_torch.core import alignment as AL
    from repro_torch.kernels import gmm_rescore as GR
    from repro_torch.kernels import ref
    dev = ex.device
    const, lin, P = ex._pack.pre
    C, D = lin.shape
    linT, Pf = lin.T.contiguous(), P.reshape(C, D * D).contiguous()
    A = ex._pack.rescore_A
    F = x.shape[0]

    def held(label, xs, ss, Cr=C, Ps=Pf, As=A):
        return compare(f"gmm_rescore {label}", GR.gmm_rescore(xs, ss, As),
                       ref.gmm_rescore(xs, ss, const[:Cr], linT[:, :Cr],
                                       Ps[:Cr]))

    held(f"ragged [1000x{K}]", x[:1000].contiguous(),
         sel[:1000].contiguous())
    Cr = 1999
    held(f"[{F}x{K}] of the first C={Cr} rows", x,
         sel.clamp(max=Cr - 1).contiguous(), Cr, As=A[:Cr].contiguous())
    held(f"[{F}x1]", x, sel[:, :1].contiguous())
    _, sel40 = AL.preselect(ex._pack.diag, x, 40)
    held(f"[{F}x40]", x, sel40.contiguous())
    del sel40
    held(f"[{F}x{K}], every frame on frame 0's ids", x,
         sel[:1].expand(F, K).contiguous())
    g2 = torch.Generator(device=dev).manual_seed(g.initial_seed() + 4)
    skew = torch.randn(C, D, D, generator=g2, device=dev)
    Pn = (P + 0.05 * P.abs().max() * (skew - skew.transpose(1, 2))
          ).reshape(C, D * D).contiguous()
    del skew
    held(f"[{F}x{K}], P not symmetric", x, sel, Ps=Pn,
         As=ref.rescore_pack(const, linT, Pn))
    del Pn
    # the instance for any D: P padded by 4-byte copies (D = 36), and the
    # frames too where a row is not 16-byte aligned (D = 7)
    for Dg in (36, 7):
        Cg, Fg = 300, 3000
        a = torch.randn(Cg, Dg, Dg, generator=g2, device=dev)
        Pg = (a @ a.transpose(1, 2) / Dg
              + torch.eye(Dg, device=dev)).reshape(Cg, Dg * Dg)
        cg_ = torch.randn(Cg, generator=g2, device=dev)
        lg = torch.randn(Dg, Cg, generator=g2, device=dev)
        xg = torch.randn(Fg, Dg, generator=g2, device=dev)
        sg = torch.randint(0, Cg, (Fg, K), generator=g2, device=dev)
        compare(f"gmm_rescore [{Fg}x{K}], D={Dg}, C={Cg}",
                GR.gmm_rescore(xg, sg, ref.rescore_pack(cg_, lg, Pg)),
                ref.gmm_rescore(xg, sg, cg_, lg, Pg))
    got = GR.gmm_rescore(x, sel, A)
    if not torch.equal(got, GR.gmm_rescore(x, sel, A)):
        fail("gmm_rescore: two calls on the same input are not bitwise "
             "equal")
    print("  gmm_rescore: two calls are bitwise equal")

    # the stats pass's shape: 512 utterances x 512 frames
    Fs = 512 * 512
    xs = frames.repeat(-(-Fs // frames.shape[0]), 1)[:Fs].contiguous()
    ss = torch.cat([AL.preselect(ex._pack.diag, xs[s:s + 16384], K)[1]
                    for s in range(0, Fs, 16384)]).contiguous()
    got = GR.gmm_rescore(xs, ss, A)
    err = 0.0
    scale = 0.0
    for s in range(0, Fs, 16384):
        want = ref.gmm_rescore(xs[s:s + 16384], ss[s:s + 16384], const,
                               linT, Pf)
        err = max(err, (got[s:s + 16384] - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
    print(f"  gmm_rescore [{Fs}x{K}]: max_abs_err {err:.3e}  (tolerance "
          f"{TOL:g} x max|plain| = {TOL * scale:.3e})  "
          f"{'ok' if err <= TOL * scale else 'DISAGREES'}")
    if err > TOL * scale:
        fail("gmm_rescore at the stats pass's shape disagrees with its "
             "plain version")
    del got, want
    spread = {f: pair_spread(s_, C) for f, s_ in ((F, sel), (Fs, ss))}
    times = {F: cuda_ms(lambda: GR.gmm_rescore(x, sel, A), 20),
             Fs: cuda_ms(lambda: GR.gmm_rescore(xs, ss, A), 5)}
    for f, sp in spread.items():
        print(f"  gmm_rescore at F={f}: {times[f]:.4f} ms; pairs over "
              f"components: {sp['distinct']} distinct ids, "
              f"{sp['mean']:.1f} pairs a component on average, at most "
              f"{sp['max']}; BP-slot fill "
              + ", ".join(f"{100 * v:.1f}% at BP={bp}"
                          for bp, v in sp["fill"].items()))
    # device time by launch (the sort's four and the rescore), one call
    split = {}
    for f, xx, s_ in ((F, x, sel), (Fs, xs, ss)):
        split[f] = profile_path(lambda: GR.gmm_rescore(xx, s_, A))["top"]
        print(f"  gmm_rescore at F={f}, device ms by launch: "
              + "; ".join(f"{short_name(name)} {ms:.4f}"
                          for name, ms, _ in split[f]))
    del xs, ss
    # the wrapper's geometry against the CUDA side's, fitting and refused
    for shape in ((F, K, C, D), (1000, 1, 1999, D), (F, 40, C, D),
                  (100, K, C, 200), (100, K, C, 201), (100, K, 58112, D),
                  (100, K, 58113, D), (2 ** 31 // K + 1, K, C, D)):
        try:
            mine = GR.geometry(*shape)
        except ValueError:
            mine = None
        if mine != GR.kernel_geometry(*shape):
            fail(f"gmm_rescore: geometry{shape} is {mine} in the wrapper, "
                 f"{GR.kernel_geometry(*shape)} in the kernel")
    g0 = GR.geometry(F, K, C, D)
    print(f"  gmm_rescore: work items of {g0.bp} pairs, at most "
          f"{g0.max_items} at F={F}; {g0.smem_bytes} bytes of shared memory "
          f"a block (the kernel's own answer, as the wrapper's)")
    return {"times": times, "spread": spread, "split": split,
            "geometry": g0._asdict()}


# packed_matmul's rows: (row, wrapper, "<dtype>_<form>" of its launch
# counter); the bf16 rows run on no main path of this script
TVM_ROWS = {"tvm_estep_l": ("tvm_estep_l", "float32_stream"),
            "tvm_estep_l_train": ("tvm_estep_l", "float32_sgemm"),
            "tvm_estep_l_bf16": ("tvm_estep_l", "bfloat16_stream"),
            "tvm_estep_l_bf16_train": ("tvm_estep_l", "bfloat16_wgmma"),
            "tvm_estep_a": ("tvm_estep_a", "float32_sgemm"),
            "tvm_estep_a_bf16": ("tvm_estep_a", "bfloat16_wgmma")}
OFF_PATH = ("tvm_estep_l_bf16", "tvm_estep_l_bf16_train", "tvm_estep_a_bf16",
            "gmm_rescore_hist_global")


def check_packed_matmul(ex, C: int, g):
    """The packed E-step matmul in each of its forms, at the shapes the
    paths launch: L = n @ U_p at serving (U = 16, the stream form) and at
    training and extract (U = 512, estep_chunk: the SGEMM), A = nᵀ @ PP
    (U = 512, the SGEMM), each in f32 and with bf16 inputs (stream and
    wgmma forms); then ragged shapes that take the kernels' masked edges,
    their unaligned copies and the wgmma form's TMA padding, held but not
    timed. Bounds: 2·M·K·N operations against the inputs read once and the
    f32 output written once; library: one torch.matmul (f32) or torch.mm
    with an f32 output (bf16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import tvm_estep as TE
    dev = ex.device
    Up = ex._tv_pre.U
    Pn = Up.shape[1]
    # drawn as in earlier runs, so that later phases see the same draws
    n16 = 50.0 * torch.rand(16, C, generator=g, device=dev)
    n512 = 50.0 * torch.rand(512, C, generator=g, device=dev)
    PP = torch.randn(512, Pn, generator=g, device=dev)
    # (row for f32 inputs, row for bf16 inputs, product, n, b)
    cases = (("tvm_estep_l", "tvm_estep_l_bf16", "L", n16, Up),
             ("tvm_estep_l_train", "tvm_estep_l_bf16_train", "L", n512, Up),
             ("tvm_estep_a", "tvm_estep_a_bf16", "A", n512, PP))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = _dtype_name(dtype)
        for f32_name, bf16_name, which, n, b in cases:
            name = f32_name if dtype == torch.float32 else bf16_name
            n, b = n.to(dtype).contiguous(), b.to(dtype)
            if which == "L":
                run, plain = TE.tvm_estep_l, ref.tvm_estep_l
                M, K = n.shape
                lib_a = n
            else:
                run, plain = TE.tvm_estep_a, ref.tvm_estep_a
                K, M = n.shape
                lib_a = n.T
            form = TE.form(dtype, M, K, Pn)
            shape = (f"[{M}x{K}] @ [{K}x{Pn}]" if which == "L"
                     else f"[{K}x{M}]ᵀ @ [{K}x{Pn}]")
            err = compare(f"{name} {shape} {tag}, {form} form",
                          run(n, b), plain(n, b))
            b_ms, b_by = bound("tvm_estep", M=M, K=K, N=Pn, dtype=tag)
            if dtype == torch.float32:
                lib = cuda_ms(lambda: torch.matmul(lib_a, b), 10)
            else:
                lib = cuda_ms(lambda: torch.mm(lib_a, b,
                                               out_dtype=torch.float32), 10)
            rows.append(dict(
                name=name, route="cuda",
                source="src/repro_torch/csrc/packed_matmul.cu",
                replaces="src/repro/kernels/tvm_estep.py:63", form=form,
                max_abs_err=err, ms=cuda_ms(lambda: run(n, b), 10),
                plain_ms=cuda_ms(lambda: plain(n, b), 10),
                bound_ms=b_ms, bound_by=b_by, library_ms=lib))
            del n, b, lib_a
        torch.cuda.empty_cache()
    del cases, n16, n512, PP
    # ragged: U, C and P off every tile, with rows 16-byte aligned (zero-
    # filled copies, TMA's edge) and not (odd C and P: plain copies in the
    # CUDA-core forms, a TMA pad in the wgmma form); C = 13 sends A to the
    # stream form, which then reads nᵀ M-contiguous
    g2 = torch.Generator(device=dev).manual_seed(g.initial_seed() + 2)
    for U, Cr, Pr in ((200, 2000, 1000), (200, 2001, 1003), (9, 2001, 1003),
                      (40, 13, 77)):
        n = torch.rand(U, Cr, generator=g2, device=dev)
        b_l = torch.randn(Cr, Pr, generator=g2, device=dev)
        b_a = torch.randn(U, Pr, generator=g2, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            nd, bl, ba = n.to(dtype), b_l.to(dtype), b_a.to(dtype)
            tag = _dtype_name(dtype)
            compare(f"tvm_estep_l ragged [{U}x{Cr}] @ [{Cr}x{Pr}] {tag}, "
                    f"{TE.form(dtype, U, Cr, Pr)} form",
                    TE.tvm_estep_l(nd, bl), ref.tvm_estep_l(nd, bl))
            compare(f"tvm_estep_a ragged [{U}x{Cr}]ᵀ @ [{U}x{Pr}] {tag}, "
                    f"{TE.form(dtype, Cr, U, Pr)} form",
                    TE.tvm_estep_a(nd, ba), ref.tvm_estep_a(nd, ba))
    return rows


def check_bw_stats(ex, frames, K: int, g):
    """bw_stats at a train_ubm chunk's shape: Γ [32768, 2048] from the
    alignment of real frames (top-20, no floor, as in the full UBM phase),
    x [32768, 72]. Each component tile walks only its frames with a
    non-zero Γ (the default); the same Γ after the fused path's 0.025
    floor and a dense Γ (random positive) are held and timed too, each
    both compacted and walking every frame (``compact=False``). Prints Γ's
    non-zero share and the share of (frame, 128- or 64-component tile)
    pairs with a non-zero Γ. The bound counts the dense work, 2·F·C·E
    (``touched_bound_ms``: over the touched (frame, tile) pairs only). The
    library column is one ``torch.matmul(Γᵀ, X₂)`` over the packed width
    the kernel computes, X₂ = [x_i x_j (i <= j) | x | 1] built beforehand;
    ``library_full_ms`` is the same call over all D² products."""
    from repro_torch.core import alignment as AL
    from repro_torch.kernels import bw_stats as BW
    from repro_torch.kernels import ref
    pack = ex._pack
    C, D = pack.pre[1].shape
    x = frames[:32768].contiguous()
    F = x.shape[0]
    post = AL.align_frames(x, pack.full, pack.diag, top_k=K, floor=0.0,
                           precomp=pack.pre, rescore="sparse",
                           rescore_pack=pack.rescore_A)
    gamma = torch.zeros((F, C), device=x.device)
    for k in range(K):
        gamma.scatter_add_(1, post.indices[:, k:k + 1],
                           post.values[:, k:k + 1])
    del post
    got = BW.bw_stats(gamma, x)
    want = ref.bw_stats(gamma, x)
    err = max(compare(f"bw_stats {name} [{F}x{C}]ᵀ [{F}x{D}]", a, w)
              for name, a, w in zip(("n", "f", "S"), got, want))
    del got, want
    g2 = torch.Generator(device=x.device).manual_seed(g.initial_seed() + 3)
    cases = {"path": gamma, "floor": gamma * (gamma >= 0.025),
             "dense": torch.rand(F, C, generator=g2, device=x.device)}
    shares, times = {}, {}
    for label, gm in cases.items():
        nz = gm != 0
        shares[label] = {"nonzero": nz.float().mean().item(), **{
            f"tiles{w}": nz.reshape(F, C // w, w).any(dim=2).float().mean()
            .item() for w in (128, 64)}}
        del nz
        want = ref.bw_stats(gm, x)
        for compact in (True, False):
            tag = "compacted" if compact else "every frame"
            compare(f"bw_stats S, {label} Γ, {tag}",
                    BW.bw_stats(gm, x, compact=compact)[2], want[2])
            times[f"{label}_{'compact' if compact else 'walk'}_ms"] = \
                cuda_ms(lambda: BW.bw_stats(gm, x, compact=compact), 5)
        del want
        sh = shares[label]
        print(f"  bw_stats, {label} Γ: non-zero share {sh['nonzero']:.4f}; "
              f"(frame, tile) pairs touched: 128-wide {sh['tiles128']:.4f}, "
              f"64-wide {sh['tiles64']:.4f}; compacted "
              f"{times[label + '_compact_ms']:.4f} ms, every frame "
              f"{times[label + '_walk_ms']:.4f} ms")
    i0, i1, _ = ref._quad_pairs(D, x.device)
    x2p = torch.cat([x[:, i0] * x[:, i1], x, torch.ones_like(x[:, :1])],
                    dim=1)
    x2 = (x[:, :, None] * x[:, None, :]).reshape(F, D * D)
    gT = gamma.T
    # S_c is symmetric: the function needs D(D+1)/2 products per (frame,
    # component) for S, D for f and 1 for n; it writes all of S
    b_ms, b_by = bound("bw_stats", F=F, C=C, D=D)
    t_ms, _ = bound("bw_stats", F=F, C=C, D=D,
                    touched=shares["path"]["tiles128"])
    row = dict(
        name="bw_stats", route="cuda", source="src/repro_torch/csrc/bw_stats.cu",
        replaces="src/repro/kernels/bw_stats.py:54", max_abs_err=err,
        ms=cuda_ms(lambda: BW.bw_stats(gamma, x), 5),
        plain_ms=cuda_ms(lambda: ref.bw_stats(gamma, x), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.matmul(gT, x2p), 5),
        library_full_ms=cuda_ms(lambda: torch.matmul(gT, x2), 5),
        touched_bound_ms=t_ms, splits=BW.splits(F, C, D, BW._n_sm(x.device)),
        shares=shares, times=times)
    del gamma, gT, x2, x2p, cases
    # ragged F and C, with D = 72 (the rows form: 16-byte rows, zero-filled
    # copies) and D = 70 (the pairs form), the latter also at a C that is
    # not a multiple of 4 (Γ by 4-byte copies), compacted and not
    for Dr, Cr in ((72, 2000), (70, 2000), (70, 1999)):
        xr = x[:1000, :Dr].contiguous()
        gr = torch.rand(1000, Cr, generator=g2, device=x.device)
        gr = gr * (gr > 0.9)
        gr[:, 128:256] = 0.0     # a component tile with no frames
        want = ref.bw_stats(gr, xr)
        for compact in (True, False):
            for name, a, w in zip(("n", "f", "S"),
                                  BW.bw_stats(gr, xr, compact=compact), want):
                compare(f"bw_stats {name} ragged [1000x{Cr}]ᵀ [1000x{Dr}]"
                        f"{', compacted' if compact else ''}", a, w)
    torch.cuda.empty_cache()
    return row


def held_align(label, x, dconst, dlin, dquad, A2, K, want_sel=None,
               exact: bool = False):
    """gmm_align against the plain preselect + packed rescore: the selected
    sets compared frame by frame (the share that agrees is printed and held
    to ALIGN_AGREE), sel_ll held to TOL on the frames that agree (with
    ``exact``, to TOL of the rescore's float64 value, ``held_exact``).
    Returns (max error, the kernel's sel)."""
    from repro_torch.kernels import gmm_align as GA
    from repro_torch.kernels import ref
    F = x.shape[0]
    ll, sel = GA.gmm_align(x, dconst, dlin, dquad, A2, K)
    if want_sel is None:
        want_sel = ref.diag_topk(x, dconst, dlin, dquad, K)[1]
    want_ll = ref.gmm_rescore_fused(x, want_sel, A2)
    s_got, o_got = torch.sort(sel, dim=1)
    s_want, o_want = torch.sort(want_sel, dim=1)
    agree = (s_got == s_want).all(dim=1)
    share = agree.float().mean().item()
    print(f"  gmm_align {label}: selected sets agree on {agree.sum().item()} "
          f"of {F} frames ({100 * share:.3f}%, at least "
          f"{100 * ALIGN_AGREE:g}% required)")
    if share < ALIGN_AGREE:
        fail(f"gmm_align {label} selects other components than its plain "
             "version")
    held = agree & torch.isfinite(want_ll).all(dim=1)   # not NaN frames
    got_h = torch.gather(ll, 1, o_got)[held]
    want_h = torch.gather(want_ll, 1, o_want)[held]
    if exact:
        err = held_exact(f"gmm_align {label} sel_ll on agreeing frames",
                         got_h, want_h, exact_fused(
                             x[held], torch.gather(want_sel, 1, o_want)[held],
                             A2))
    else:
        err = compare(f"gmm_align {label} sel_ll on agreeing frames", got_h,
                      want_h)
    return err, sel


def check_gmm_align(ex, frames, K: int):
    """gmm_align at F=16384 frames against the plain preselect + packed
    rescore (``held_align``); the rescore alone (``gmm_rescore_fused``,
    the same kernel given the selection) held on every frame; then ragged
    F and C (C a multiple of 4 or not), K above the streaming merge's 32
    (the whole-row instance, 16 frames a block, and 8 at C = 4096), and,
    for both instances, the NaN rule (a frame of NaNs takes C-1 in every
    slot; a NaN score at C-1 alone puts C-1 first, then the best K-1 of the
    others) and zero-weight components (a dconst of -inf leaving fewer than
    K scores above it: the slots after take id 0), each against
    ``ref.argmax_topk`` of the plain scores. The wrapper's ``geometry`` is
    held against the CUDA side's for the shapes run here."""
    from repro_torch.core import ubm as U
    from repro_torch.kernels import gmm_align as GA
    from repro_torch.kernels import ref
    pack = ex._pack
    dconst, dlin, dquad = (t.contiguous() for t in U.diag_coeffs(pack.diag))
    A2 = pack.align_A
    C, E2 = A2.shape
    x = frames[:16384].contiguous()
    F, D = x.shape
    err, sel = held_align(f"[{F}x{D}] C={C} K={K}", x, dconst, dlin, dquad,
                          A2, K)
    compare(f"gmm_rescore_fused [{F}x{K}] on the kernel's selection",
            GA.gmm_rescore_fused(x, sel, A2),
            ref.gmm_rescore_fused(x, sel, A2))
    for Fr, Cr, Kr in ((1000, 2000, K), (1000, 1999, K), (2048, C, 40)):
        held_align(f"ragged [{Fr}x{D}] C={Cr} K={Kr}", x[:Fr].contiguous(),
                   dconst[:Cr].contiguous(), dlin[:, :Cr].contiguous(),
                   dquad[:, :Cr].contiguous(), A2[:Cr].contiguous(), Kr)
    # C = 2C: the second half's components are the first's with dconst
    # moved by one, so no score ties exactly with the first half's
    held_align(f"[1000x{D}] C={2 * C} K=40 (8-frame blocks)",
               x[:1000].contiguous(),
               torch.cat([dconst, dconst.roll(1)]).contiguous(),
               torch.cat([dlin, dlin], 1).contiguous(),
               torch.cat([dquad, dquad], 1).contiguous(),
               torch.cat([A2, A2]).contiguous(), 40)
    xn = x[:1000].clone()
    xn[3] = float("nan")
    dn = dconst.clone()
    dn[C - 1] = float("nan")
    finite = torch.arange(5, C, 150, device=dconst.device)   # 14 of them
    dz = torch.full_like(dconst, float("-inf"))
    dz[finite] = dconst[finite]
    for Kr in (K, 40):
        scores = ref.diag_topk(xn, dn, dlin, dquad, Kr)[0]
        _, seln = held_align(f"NaN rule K={Kr}", xn, dn, dlin, dquad, A2, Kr,
                             ref.argmax_topk(scores, Kr))
        if not ((seln[3] == C - 1).all() and (seln[:, 0] == C - 1).all()):
            fail("gmm_align breaks the NaN rule")
        scores = ref.diag_topk(x[:1000], dz, dlin, dquad, Kr)[0]
        _, selz = held_align(f"zero-weight components K={Kr}",
                             x[:1000].contiguous(), dz, dlin, dquad, A2, Kr,
                             ref.argmax_topk(scores, Kr))
        if not (selz[:, finite.numel():] == 0).all():
            fail("gmm_align breaks the -inf rule")
    for shape in ((C, D, K), (1999, D, K), (C, D, 40), (2 * C, D, 40),
                  (C, D, C), (6272, D, 40), (6273, D, 40), (C, D, 40, True)):
        try:
            mine = GA.geometry(*shape)
        except ValueError:
            mine = None
        if mine != GA.kernel_geometry(*shape):
            fail(f"gmm_align: geometry{shape} is {mine} in the wrapper, "
                 f"{GA.kernel_geometry(*shape)} in the kernel")
    b_ms, b_by = bound("gmm_align", F=F, C=C, D=D, K=K,
                       rows_touched=torch.unique(sel).numel())
    # the split: the rescore alone is the same kernel given the selection
    # (sel_in), the rest is the preselect and the top-K
    ms = cuda_ms(lambda: GA.gmm_align(x, dconst, dlin, dquad, A2, K), 20)
    rescore_ms = cuda_ms(lambda: GA.gmm_rescore_fused(x, sel, A2), 20)
    print(f"  gmm_align split at F={F}: whole {ms:.4f} ms; rescore alone "
          f"(gmm_rescore_fused) {rescore_ms:.4f} ms; preselect + top-K "
          f"{ms - rescore_ms:.4f} ms")
    # distinct component ids among a frame tile's (frame, slot) pairs: the
    # rows a rescore grouped by id would read once per tile
    distinct = {}
    for bf in (32, 64):
        s = torch.sort(sel[:F // bf * bf].reshape(-1, bf * K), dim=1).values
        n = 1 + (s[:, 1:] != s[:, :-1]).sum(dim=1)
        distinct[bf] = n.float().mean().item() / (bf * K)
        print(f"  gmm_align: distinct ids in a {bf}-frame tile: "
              f"{n.float().mean().item():.1f} of {bf * K} (frame, slot) "
              f"pairs ({100 * distinct[bf]:.1f}%)")
    g0 = GA.kernel_geometry(C, D, K)
    bf, smem = g0.rows, g0.smem
    print(f"  gmm_align: {bf} frames a block, {smem} bytes of shared memory "
          f"a block (the kernel's own answer, as the wrapper's)")
    return dict(
        name="gmm_align", route="cuda",
        source="src/repro_torch/csrc/gmm_align.cu",
        replaces="src/repro/kernels/gmm_align.py:162", max_abs_err=err,
        ms=ms,
        plain_ms=cuda_ms(
            lambda: ref.gmm_align(x, dconst, dlin, dquad, A2, K), 5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        rescore_ms=rescore_ms, distinct_share=distinct, smem_bytes=smem)


def counters():
    from repro_torch.kernels import bw_stats as BW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gmm_align as GA
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import gmm_rescore as GR
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.kernels import tvm_estep as TE
    return {"gmm_loglik": GL.gmm_loglik, "gmm_rescore": GR.gmm_rescore,
            "tvm_estep_l": TE.tvm_estep_l, "tvm_estep_a": TE.tvm_estep_a,
            "bw_stats": BW.bw_stats, "gmm_align": GA.gmm_align,
            "gmm_rescore_fused": GA.gmm_rescore_fused,
            "flash_attention": FA.flash_attention,
            "flash_attention_bwd": FA.flash_attention_bwd,
            "selective_scan": SS.selective_scan,
            "selective_scan_bwd": SS.selective_scan_bwd}


# the scan's launches by form (selective_scan.FORMS): (row suffix,
# scan_dtype); the f32 form keeps the plain rows' names
SCAN_FORMS = (("", "float32"), ("_bf16", "bfloat16"), ("_f16", "float16"))


# the i-vector kernels' new forms (phase 16): row -> ((wrapper, form), ...)
# whose launches it sums
IVEC_FORM_ROWS = {
    "gmm_loglik_wide": (("gmm_loglik", "wide"),),
    "bw_stats_pairs": (("bw_stats", "pairs"),),
    "gmm_rescore_strips": (("gmm_rescore", "strips"),),
    "gmm_rescore_hist_global": (("gmm_rescore", "hist_global"),),
    "gmm_align_wide": (("gmm_align", "wide"), ("gmm_rescore_fused", "wide")),
    "gmm_align_spill": (("gmm_align", "spill"),)}


# the attention's forms with rows of their own (phase 17;
# flash_attention.form): the row is "<wrapper>_<form>"; "simt" is f32 on
# the CUDA cores at every head dim
ATTENTION_FORMS = ("tc8", "staged", "wide", "simt")


def reset_counts() -> None:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.kernels import tvm_estep as TE
    ws = counters()
    for w in ws.values():
        w.launches = 0
    for parts in IVEC_FORM_ROWS.values():
        for name, form in parts:
            ws[name].by_form[form] = 0
    TE.reset_counts()
    SS.reset_counts()
    FA.reset_counts()


def read_counts() -> dict:
    """Launches by kernel row: packed_matmul's by form (TVM_ROWS), the
    scan's and its backward's by form (SCAN_FORMS) and, past 64 states, by
    form again ("_grouped" rows), the attention's and its backward's
    ATTENTION_FORMS, the i-vector kernels' new forms (IVEC_FORM_ROWS)."""
    ws = counters()
    counts = {k: w.launches for k, w in ws.items()
              if k not in ("tvm_estep_l", "tvm_estep_a")}
    for row, (name, key) in TVM_ROWS.items():
        counts[row] = ws[name].by_form[key]
    for name in ("selective_scan", "selective_scan_bwd"):
        for suffix, sd in SCAN_FORMS:
            counts[name + suffix] = ws[name].by_form[sd]
            counts[f"{name}_grouped{suffix}"] = ws[name].by_form_grouped[sd]
    for name in ("flash_attention", "flash_attention_bwd"):
        for form in ATTENTION_FORMS:
            counts[f"{name}_{form}"] = ws[name].by_form[form]
    for row, parts in IVEC_FORM_ROWS.items():
        counts[row] = sum(ws[name].by_form[form] for name, form in parts)
    return counts


def drive(ex, utts, label: str):
    """Serve ``utts`` once with every launch count set to 0 just before;
    returns (i-vectors, launches by kernel, wall seconds)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iv = ex.extract(utts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    frames = sum(u.shape[0] for u in utts)
    audio_s = frames / 100.0      # 10 ms frame shift
    print(f"  {label}: {len(utts)} requests, {frames} frames in "
          f"{wall:.3f} s: {len(utts) / wall:.1f} utts/s, real-time factor "
          f"{wall / audio_s:.2e} ({audio_s / wall:.0f}x real time); "
          f"launches {launches}")
    return iv, launches, wall


def profile_path(fn):
    """One call of ``fn`` under ``torch.profiler``: its wall time (inflated
    by the profiler), the device's busy time (the sum of device-side
    events, kernels and copies, all on one stream) and device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
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


def synthetic_corpus(ubm, n_utts: int, n_frames: int, g,
                     every_component: bool = False):
    """[n_utts, n_frames, D] frames drawn from the UBM, each utterance with
    its own offset. ``every_component`` deals the components out evenly
    (each generates n_utts*n_frames/C frames, in shuffled order), so that
    no component goes without frames."""
    C, D = ubm.means.shape
    dev = ubm.means.device
    N = n_utts * n_frames
    if every_component:
        comp = (torch.arange(N, device=dev) % C)[
            torch.randperm(N, generator=g, device=dev)]
    else:
        comp = torch.multinomial(ubm.weights, N, replacement=True,
                                 generator=g)
    chol = torch.linalg.cholesky(ubm.covs)
    x = torch.empty((N, D), device=dev)
    for s in range(0, N, 32768):
        c = comp[s:s + 32768]
        z = torch.randn(c.shape[0], D, 1, generator=g, device=dev)
        x[s:s + 32768] = ubm.means[c] + (chol[c] @ z)[..., 0]
    shift = 0.2 * torch.randn(n_utts, 1, D, generator=g, device=dev)
    return x.reshape(n_utts, n_frames, D) + shift


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_finite(label: str, *tensors) -> None:
    for t in tensors:
        if not torch.isfinite(t).all():
            fail(f"{label}: non-finite values")


def timed_train(cfg, ubm, feats, n_iters: int, seed: int, dev):
    """``trainer.train`` with the launch counts set to 0 just before; returns
    (state, seconds to each iteration's end, diagnostics, launches)."""
    from repro_torch.core import trainer as TR
    ends, diags = [], []

    def cb(state, diag):
        _sync(dev)
        ends.append(time.perf_counter())
        diags.append({k: float(v) for k, v in diag.items()})

    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    state = TR.train(cfg, ubm, feats, n_iters=n_iters,
                     generator=torch.Generator().manual_seed(seed),
                     callback=cb, device=dev)
    secs = [e - s for s, e in zip([t0] + ends[:-1], ends)]
    check_finite("training", state.model.T, state.model.Sigma,
                 state.model.prior, state.ubm.covs)
    return state, secs, diags, read_counts()


def require_launches(label: str, launches: dict, names) -> None:
    for k in names:
        if launches[k] == 0:
            fail(f"{label} never launched {k}")


def training_phase(cfg, ubm, g, seed: int, dev, n_utts: int = 640,
                   n_frames: int = 512):
    """UBM training, both trainer branches, the repeat run and extraction on
    [n_utts, n_frames, D] frames drawn from ``ubm``; returns a record."""
    from repro_torch.core import trainer as TR
    from repro_torch.core import ubm as U
    C, D = ubm.means.shape
    feats = synthetic_corpus(ubm, n_utts, n_frames, g)
    rec = {"utterances": n_utts, "frames_per_utt": n_frames,
           "audio_s": n_utts * n_frames / 100.0, "launches": {}}
    print(f"  corpus: {n_utts} utterances x {n_frames} frames "
          f"({rec['audio_s'] / 60:.1f} min of audio at 10 ms)")

    # train_ubm on the flat frames: 4096-frame pseudo-utterances, chunks
    # of 8 (32,768 frames), Kaldi's top-20 gselect
    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    ubm_t = U.train_ubm(feats.reshape(-1, D), C,
                        torch.Generator(device=dev).manual_seed(seed),
                        diag_iters=2, full_iters=2, top_k=cfg.posterior_top_k,
                        device=dev)
    _sync(dev)
    rec["train_ubm_s"] = time.perf_counter() - t0
    rec["launches"]["train_ubm"] = read_counts()
    check_finite("train_ubm", ubm_t.weights, ubm_t.means, ubm_t.covs)
    if torch.linalg.cholesky_ex(ubm_t.covs).info.any():
        fail("train_ubm: a covariance is not positive definite")
    require_launches("train_ubm", rec["launches"]["train_ubm"],
                     ("gmm_loglik", "bw_stats"))
    print(f"  train_ubm (2 diag + 2 full iterations, top-20): "
          f"{rec['train_ubm_s']:.2f} s; launches "
          f"{rec['launches']['train_ubm']}")

    # the stats pass alone (the trainer's no-realignment branch runs it
    # once, before its first iteration)
    _sync(dev)
    t0 = time.perf_counter()
    st, _ = TR.stats_ll(cfg, ubm_t, feats)
    _sync(dev)
    rec["stats_pass_s"] = time.perf_counter() - t0
    del st
    state, secs, diags, launches = timed_train(cfg, ubm_t, feats, 3, seed,
                                               dev)
    rec.update(train_iter_s=secs, train_diag=diags)
    rec["launches"]["train"] = launches
    require_launches("train", launches, ("gmm_rescore", "bw_stats",
                                         "tvm_estep_l_train", "tvm_estep_a"))
    print(f"  train, CONFIG (sparse, statistics once): stats pass "
          f"{rec['stats_pass_s']:.2f} s; iterations "
          f"{', '.join(f'{t:.2f}' for t in secs)} s (the first includes "
          f"the stats pass); launches {launches}")
    del state

    cfg_f = cfg.with_overrides(rescore="fused", realign_interval=1,
                               ubm_update="full")
    state_f, secs_f, diags_f, launches = timed_train(cfg_f, ubm_t, feats, 3,
                                                     seed, dev)
    rec.update(fused_iter_s=secs_f, fused_diag=diags_f)
    rec["launches"]["train_fused"] = launches
    require_launches("train, fused", launches, ("gmm_align", "bw_stats",
                                                "tvm_estep_l_train",
                                                "tvm_estep_a"))
    print(f"  train, fused + realignment every iteration + full UBM "
          f"refresh: iterations {', '.join(f'{t:.2f}' for t in secs_f)} s; "
          f"launches {launches}")
    for d in diags_f:
        print(f"    avg loglik {d['avg_loglik']:.4f}, mean |phi| "
              f"{d['mean_phi_norm']:.4f}")
    again, _, _, _ = timed_train(cfg_f, ubm_t, feats, 3, seed, dev)
    for a, b in zip((state_f.model.T, state_f.model.Sigma,
                     state_f.model.prior, state_f.ubm.weights,
                     state_f.ubm.means, state_f.ubm.covs),
                    (again.model.T, again.model.Sigma, again.model.prior,
                     again.ubm.weights, again.ubm.means, again.ubm.covs)):
        if not torch.equal(a, b):
            fail("the same training run twice is not bitwise equal")
    print("  repeat training run is bitwise equal")
    del again

    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    iv = TR.extract(cfg_f, state_f, feats, device=dev)
    _sync(dev)
    rec["extract_s"] = time.perf_counter() - t0
    rec["launches"]["extract"] = read_counts()
    require_launches("extract", rec["launches"]["extract"],
                     ("gmm_align", "tvm_estep_l_train"))
    iv_s = TR.extract(cfg, state_f, feats, device=dev)
    check_finite("extract", iv)
    if iv.shape != (n_utts, cfg.ivector_dim):
        fail(f"extract: shape {tuple(iv.shape)}")
    d_fs = ((iv - iv_s).abs().max() / iv_s.abs().max()).item()
    print(f"  extract: {n_utts} i-vectors in {rec['extract_s']:.2f} s; "
          f"fused vs sparse rung max |diff| / max|i-vector| {d_fs:.3e} "
          f"(tolerance {IVEC_TOL})")
    if d_fs > IVEC_TOL:
        fail("extract: fused and sparse rungs disagree")
    rec["extract_fused_vs_sparse"] = d_fs
    del iv, iv_s

    out = []
    prof = profile_path(lambda: out.append(TR.iteration(
        cfg_f, state_f.model, state_f.ubm, feats)))
    print_profile("fused iteration", prof, 10)
    rec["profile_fused_iteration"] = prof
    # the realignment write-back between iterations, alone, and the
    # PSD floor inside it; the profiler sees the floor on 64 covariances
    # only (on all 2,048 it records some 300,000 device events)
    tot = out[0][1]
    rec["refresh_ubm_s"] = host_seconds(dev, lambda: TR.refresh_ubm(
        cfg_f, state_f.model, state_f.ubm, tot))
    covs = state_f.ubm.covs
    rec["psd_floor_s"] = host_seconds(dev, lambda: U.psd_floor(covs))
    print(f"  UBM refresh ('full'): {rec['refresh_ubm_s']:.3f} s, of which "
          f"psd_floor of {covs.shape[0]} covariances "
          f"{rec['psd_floor_s']:.3f} s")
    prof = profile_path(lambda: U.psd_floor(covs[:64]))
    print_profile("psd_floor of 64 covariances", prof, 5)
    rec["profile_psd_floor_64"] = prof
    return rec


def host_seconds(dev, fn) -> float:
    """Host-clock seconds of one call of ``fn``, synchronised on both ends."""
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    return time.perf_counter() - t0


def print_profile(label: str, prof, n: int) -> None:
    print(f"  profiled {label}: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_ms']:.1f} ms "
          f"({100 * prof['device_ms'] / prof['wall_ms']:.0f}%); top device "
          "time by kernel (ms):")
    for name, ms, calls in prof["top"][:n]:
        print(f"    {ms:9.3f}  x{calls:<5d} {name[:90]}")


def model_invariants(model, mean_phi_norm, avg_loglik):
    """Quantities of a trained TV model that min_divergence's eigenvector
    signs leave alone, in float64, computed on the model's device and
    returned on the CPU."""
    T = model.T.double()
    prior = model.prior.double()
    inv = {"T_c T_c^T": torch.einsum("cdr,cer->cde", T, T),
           "T[:,:,0] p": T[:, :, 0] * prior[0],
           "|prior|": torch.linalg.norm(prior),
           "Sigma": model.Sigma.double(),
           "mean_phi_norm": torch.tensor(float(mean_phi_norm)),
           "avg_loglik": torch.tensor(float(avg_loglik))}
    return {k: v.cpu() for k, v in inv.items()}


def training_vs_cpu(cfg, ubm, seed: int, dev):
    """One fused training iteration on 64 utterances x 256 frames at full
    width, on the card and on the CPU plain path, for CPU_CHECK_RUNS
    corpora and initial Ts; every component generates 8 of the frames, so
    no M-step solve is starved.

    The alignment (``alignment.align_frames``, as the statistics pass runs
    it) is held frame by frame: a posterior within f32 rounding of the
    0.025 floor, or a component tied at the K-th place, is kept on one side
    and not on the other, so POST_AGREE of the frames must select the same
    components with posteriors within POST_TOL. The EM iteration
    (``trainer.em_iter``, which ``train`` runs) then runs on each side from
    the same statistics, the card's, so its invariants differ by f32
    rounding alone."""
    from repro_torch.core import alignment as AL
    from repro_torch.core import engine as EN
    from repro_torch.core import trainer as TR
    from repro_torch.core import tvm as TV
    cfg1 = cfg.with_overrides(rescore="fused")
    cpu = torch.device("cpu")
    runs = []
    for r in range(CPU_CHECK_RUNS):
        g = torch.Generator(device=dev).manual_seed(seed + 1 + r)
        feats = synthetic_corpus(ubm, 64, 256, g, every_component=True)
        x = feats.reshape(-1, feats.shape[-1])
        post, avg_ll, secs = {}, {}, {}
        for where, d in (("card", dev), ("cpu", cpu)):
            pack = EN.pack_ubm(ubm, d)
            _sync(d)
            t0 = time.perf_counter()
            post[where], lse = AL.align_frames(
                x.to(d), pack.full, pack.diag, top_k=cfg1.posterior_top_k,
                floor=cfg1.posterior_floor, precomp=pack.pre,
                with_loglik=True, rescore="fused", align_pack=pack.align_A)
            avg_ll[where] = lse.mean().item()
            _sync(d)
            secs[where] = time.perf_counter() - t0
        pc, pp = post["card"], post["cpu"]
        agree = ((pc.indices.cpu() == pp.indices).all(dim=1)
                 & ((pc.values.cpu() - pp.values).abs() <= POST_TOL)
                 .all(dim=1))
        share = agree.float().mean().item()
        print(f"  alignment, 64 x 256 frames, run {r}: {int(agree.sum())} of "
              f"{agree.numel()} frames agree ({100 * share:.3f}%, at least "
              f"{100 * POST_AGREE:g}% required)")
        if share < POST_AGREE:
            fail("the alignments on the card and on the CPU disagree")
        st, _ = TR.stats_ll(cfg1, ubm, feats)
        inv = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            u = ubm.to(d)
            model = TV.init_model(torch.Generator().manual_seed(seed + r),
                                  u.means, u.covs, cfg1.ivector_dim,
                                  cfg1.formulation, cfg1.prior_offset)
            _sync(d)
            t0 = time.perf_counter()
            model, diag = TR.em_iter(cfg1, model, st.n.to(d), st.f.to(d),
                                     st.S.to(d))
            _sync(d)
            secs[where] += time.perf_counter() - t0
            check_finite("training vs CPU", model.T, model.Sigma)
            inv[where] = model_invariants(model, diag["mean_phi_norm"],
                                          avg_ll[where])
        print(f"  alignment + one EM iteration, run {r}: card "
              f"{secs['card']:.2f} s, CPU plain path {secs['cpu']:.2f} s")
        rel = {}
        for k, want in inv["cpu"].items():
            diff = (inv["card"][k] - want).abs().max().item()
            scale = max(want.abs().max().item(), 1e-30)
            rel[k] = diff / scale
            tol = T_INV_TOL if k in ILL_POSED else INV_TOL
            ok = diff <= tol * scale
            print(f"    {k}: max |card - CPU| {diff:.3e}, max |value| "
                  f"{scale:.3e} (tolerance {tol:g} x max|value|) "
                  f"{'ok' if ok else 'DISAGREES'}")
            if not ok:
                fail(f"training on the card and on the CPU disagree on {k}")
        runs.append({"seconds": secs, "frames_agree": share,
                     "rel_diff": rel})
    return runs


# LM kernels. f32 attention, |kernel - plain| <= 1e-5 x max|plain|: the
# same f32 products summed in another order. bf16 attention, elementwise
# against the plain version in f32 on the same (exactly widened) inputs:
# |kernel - plain| <= 2^-8 |plain| + 1e-3 rms(plain). The kernel works in
# f32 and rounds its output to bf16 once, which moves a value by at most
# half an ulp, 2^-8 of it; the second term takes the f32 reordering (near
# 1e-6 of the scale). The scan, |kernel - plain| <= 1e-4 x max|plain|: up
# to 2048 f32 steps in another order of operations
ATT_F32_TOL = 1e-5
BF16_HALF_ULP = 2.0 ** -8
BF16_RMS_FLOOR = 1e-3
SCAN_TOL = 1e-4
# LM paths at f32, full width, depth 8: the kernels against the plain
# versions on the whole prefill (1e-3 x max|logits|), and decode against
# prefill elementwise within 2e-3 + 2e-3 |prefill|, as the JAX package's
# tests/test_models.py holds them
LOGIT_TOL = 1e-3
DECODE_TOL = 2e-3


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def compare_bf16(name, got, want):
    """A bf16 result held elementwise against the f32 plain result:
    |got - want| <= 2^-8 |want| + 1e-3 rms(want). Returns max|got - want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rms = want.square().mean().sqrt().item()
    limit = BF16_HALF_ULP * want.abs() + BF16_RMS_FLOOR * rms
    ratio = (diff / limit).max().item()
    # what the plain result rounded once to bf16 reads against the same limit
    rounding = ((want.to(torch.bfloat16).float() - want).abs() / limit
                ).max().item()
    err = diff.max().item()
    ok = ratio <= 1
    print(f"  {name}: max_abs_err {err:.3e}  max |diff| / (2^-8 |plain| + "
          f"1e-3 rms(plain) = {BF16_RMS_FLOOR * rms:.3e}) {ratio:.3f} "
          f"(the plain result's own bf16 rounding: {rounding:.3f})  "
          f"{'ok' if ok else 'DISAGREES'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def check_flash_attention(g, dev):
    """flash_attention against its plain version: Jamba's shapes (the
    serving path's, bf16, and f32), StableLM's (bf16), a ragged S (f32 and
    bf16), a short S of one partial tile (bf16), Gemma 2B's prefill at
    head dim 256 under MQA (bf16, the tensor-core instance of 64-row
    blocks, and f32) with a ragged and a short S (bf16), and the bf16
    prefill shapes of the other zoo serving paths: Phi-3-medium,
    Nemotron-4, Whisper's decoder (S = 448, not a multiple of the 128-row
    block) and InternVL2 (256 patches + 768 tokens, a group of 7); then
    the bf16 shapes of the MoE serving paths, Moonlight (MHA at hd 128)
    and Arctic (a group of 7 at hd 128), and the training forwards of
    Moonlight (4 x 4096) and InternVL2 (256 patches + 3,840 tokens), on a
    generator of their own. The row is the first case, the Jamba prefill
    of the serving path. Each case prints the kernel it ran (bf16 on the tensor
    cores, f32 on the CUDA cores)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # the later cases draw from a generator of their own, so that the
    # earlier cases and the phases after this one see the draws they had
    g2 = torch.Generator(device=dev).manual_seed(g.initial_seed() + 1)
    g3 = torch.Generator(device=dev).manual_seed(g.initial_seed() + 2)
    g4 = torch.Generator(device=dev).manual_seed(g.initial_seed() + 3)
    cases = (("Jamba", 4, 2048, 32, 8, 128, torch.bfloat16, g),
             ("Jamba", 4, 2048, 32, 8, 128, torch.float32, g),
             ("StableLM", 8, 1024, 32, 32, 64, torch.bfloat16, g),
             ("ragged S", 2, 1000, 32, 8, 128, torch.float32, g),
             ("ragged S", 2, 1000, 32, 8, 128, torch.bfloat16, g2),
             ("short S", 2, 80, 32, 8, 128, torch.bfloat16, g2),
             ("Gemma", 4, 2048, 8, 1, 256, torch.bfloat16, g3),
             ("Gemma", 4, 2048, 8, 1, 256, torch.float32, g3),
             ("Gemma ragged S", 2, 1000, 8, 1, 256, torch.bfloat16, g3),
             ("Gemma short S", 1, 80, 8, 1, 256, torch.bfloat16, g3),
             ("Phi-3 serving", 4, 1024, 40, 10, 128, torch.bfloat16, g3),
             ("Nemotron serving", 4, 1024, 48, 8, 128, torch.bfloat16, g3),
             ("Whisper decoder serving", 4, 448, 20, 20, 64, torch.bfloat16,
              g3),
             ("InternVL2 serving", 4, 1024, 14, 2, 64, torch.bfloat16, g3),
             ("Moonlight serving", 4, 1024, 16, 16, 128, torch.bfloat16, g4),
             ("Arctic serving", 4, 1024, 56, 8, 128, torch.bfloat16, g4),
             ("Moonlight training", 4, 4096, 16, 16, 128, torch.bfloat16,
              g4),
             ("InternVL2 training", 4, 4096, 14, 2, 64, torch.bfloat16, g4))
    recs = []
    for label, B, S, H, KVH, hd, dtype, gen in cases:
        q, k, v = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                   .to(dtype) for n in (H, KVH, KVH))
        tag = _dtype_name(dtype)
        name = f"flash_attention {label} B={B} S={S} H={H} KVH={KVH} " \
               f"hd={hd} {tag}, {FA.KERNELS[dtype][1]} kernel"
        if dtype == torch.float32:
            err = compare(name, FA.flash_attention(q, k, v),
                          ref.flash_attention(q, k, v), ATT_F32_TOL)
        else:
            err = compare_bf16(name, FA.flash_attention(q, k, v),
                               ref.flash_attention(q.float(), k.float(),
                                                   v.float()))
        b_ms, b_by = bound("flash_attention", B=B, S=S, H=H, KVH=KVH,
                           hd=hd, dtype=tag)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        recs.append(dict(
            case=f"{label} B={B} S={S} H={H} KVH={KVH} hd={hd} {tag}",
            kernel=FA.KERNELS[dtype][1],
            max_abs_err=err, ms=cuda_ms(lambda: FA.flash_attention(q, k, v),
                                        10),
            plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v), 3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True), 10)))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:80",
               **{k: recs[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")})
    return row, recs


def check_selective_scan(g, dev):
    """selective_scan against its plain version on y and h_last: at
    Jamba's full width (di=8192, ds=16) the prefill (B=4, T=2048, no h0:
    the row), the same with h0, a decode step (B=4, T=1, with h0: the
    shape of every Jamba decode step) and a ragged T=1000 with h0; the
    prefill at d_state 8 (Jamba's SMOKE d_state) with h0; then the other
    d_state instances at ragged widths (di not a multiple of the block's
    64 channels, or of 4). No single PyTorch call computes the scan."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import selective_scan as SS
    A_of = {}
    recs = []
    for label, B, T, di, ds, with_h0 in (
            ("no h0", 4, 2048, 8192, 16, False),
            ("with h0", 4, 2048, 8192, 16, True),
            ("decode step, with h0", 4, 1, 8192, 16, True),
            ("ragged T, with h0", 2, 1000, 8192, 16, True),
            ("d_state 8, with h0", 4, 2048, 8192, 8, True),
            ("d_state 4, di not a multiple of 4, with h0", 1, 37, 1003, 4,
             True),
            ("d_state 32, ragged di, with h0", 1, 100, 1000, 32, True),
            ("d_state 64, ragged di", 1, 50, 130, 64, False)):
        if (di, ds) not in A_of:
            A_of[di, ds] = -torch.exp(
                0.5 * torch.randn(di, ds, generator=g, device=dev))
        A = A_of[di, ds]
        # as mamba_mix makes them: dt = softplus(.) > 0 near 0.01, A < 0
        dt = torch.nn.functional.softplus(
            torch.randn(B, T, di, generator=g, device=dev) - 4.6)
        dx = dt * torch.randn(B, T, di, generator=g, device=dev)
        Bc, Cc = (torch.randn(B, T, ds, generator=g, device=dev)
                  for _ in range(2))
        h = (torch.randn(B, di, ds, generator=g, device=dev) if with_h0
             else None)
        y, hl = SS.selective_scan(dt, dx, A, Bc, Cc, h)
        wy, wh = ref.selective_scan(dt, dx, A, Bc, Cc, h)
        margin = float("inf")
        err = 0.0
        for name, a, w in (("y", y, wy), ("h_last", hl, wh)):
            e = compare(f"selective_scan {label} {name} B={B} T={T} "
                        f"di={di} ds={ds}", a, w, SCAN_TOL)
            err = max(err, e)
            margin = min(margin, SCAN_TOL * w.abs().max().item()
                         / max(e, 1e-30))
        print(f"    margin: the error is {margin:.0f}x below the limit")
        # the exponentials (one per (b, t, d, s)) at the MUFU rate alone
        # are printed beside the bound, not taken into it: the FMA pipe
        # can take a share of them as a polynomial
        b_ms, b_by = bound("selective_scan", B=B, T=T, di=di, ds=ds,
                           h0=with_h0)
        recs.append(dict(
            case=f"{label} B={B} T={T} di={di} ds={ds} float32",
            max_abs_err=err, margin=margin,
            ms=cuda_ms(lambda: SS.selective_scan(dt, dx, A, Bc, Cc, h), 10),
            plain_ms=cuda_ms(lambda: ref.selective_scan(dt, dx, A, Bc, Cc, h),
                             2),
            bound_ms=b_ms, bound_by=b_by,
            mufu_ms=B * T * di * ds / mufu_rate()[0] * 1e3, library_ms=None))
        del dt, dx, Bc, Cc, h, y, hl, wy, wh
    lib = _build.load("selective_scan")
    for ds in range(1, 65):      # past 64: phase 17
        if lib.selective_scan_lanes(ds) != SS.lanes(ds):
            fail(f"selective_scan: lanes({ds}) is "
                 f"{lib.selective_scan_lanes(ds)} in the kernel, "
                 f"{SS.lanes(ds)} in the wrapper")
    row = dict(name="selective_scan", route="cuda",
               source="src/repro_torch/csrc/selective_scan.cu",
               replaces="src/repro/kernels/selective_scan.py:69",
               **{k: recs[0][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "mufu_ms",
                                          "library_ms")},
               decode_ms=recs[2]["ms"], ds8_ms=recs[4]["ms"])
    print(f"  selective_scan: prefill {row['ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); its exponentials "
          f"at the MUFU rate alone {row['mufu_ms']:.4f} ms ({mufu_rate()[1]}"
          f"); decode step {row['decode_ms']:.4f} ms; d_state 8 "
          f"{row['ds8_ms']:.4f} ms")
    return row, recs


def hybrid_steps(cfg, batch, prompt_len, gen, generator, dev):
    """Jamba's prefill and decode steps, driven as ``serve`` drives a dense
    model, with its result dict. Jamba's prefill returns no cache (as in
    the JAX package, whose launcher refuses hybrids), so the ``gen - 1``
    greedy decode steps start from the prefill's argmax token on a zero
    cache of the serving window (``prompt_len + gen``), at positions 0, 1,
    ...: the prompt does not reach them, but each step does the work of a
    step at that window."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import api
    window = prompt_len + gen
    params = api.init_params(cfg, generator, max_seq=window, device=dev)
    prefill = api.make_prefill_step(cfg)
    decode = api.make_decode_step(cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=generator, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    _, logits = prefill(params, {"tokens": prompts})
    cache = api.zero_cache(cfg, ShapeConfig("serve", window, batch,
                                            "decode"), dev)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        cache, logits = decode(params, cache, {"token": tok, "pos": i})
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(dev)
    return {"tokens": torch.stack(out, dim=1).cpu(),
            "prefill_logits": prefill_logits, "last_logits": logits,
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0,
            "params": params, "prompts": prompts}


def pad_self_cache(cache, window: int):
    """``serve.pad_cache`` on the self-attention's k and v only: the JAX
    ``pad_cache`` it mirrors would also grow the cross-attention's xk and
    xv where the window is longer than the encoder's frames, and the
    zero keys would then take part in the cross-attention."""
    from repro_torch.launch import serve as SV
    out = dict(cache)
    out.update(SV.pad_cache({k: cache[k] for k in ("k", "v")}, window))
    return out


def media_steps(cfg, batch, prompt_len, gen, generator, dev):
    """An audio (Whisper) or vlm (InternVL2) model's prefill and decode
    steps, driven as ``serve`` drives a token LM (its launcher refuses
    these families, as the JAX one does), with its result dict: ``batch``
    prompts of ``prompt_len`` tokens with random frames (audio, the
    encoder's ``n_frames``) or patches (vlm), one prefill, its cache
    padded to the window (the patches, the prompt and ``gen`` tokens;
    ``pad_self_cache``), then ``gen - 1`` greedy decode steps at the
    positions after the prompt."""
    from repro_torch.models import api
    enc = cfg.encoder
    prefix = enc.n_frames if cfg.family == "vlm" else 0
    window = prefix + prompt_len + gen
    params = api.init_params(cfg, generator, max_seq=window, device=dev)
    prefill = api.make_prefill_step(cfg)
    decode = api.make_decode_step(cfg)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=generator, device=dev)
    inputs = {"tokens": prompts,
              "frames" if cfg.family == "audio" else "patches": torch.randn(
                  batch, enc.n_frames, enc.frontend_dim, generator=generator,
                  device=dev)}
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = prefill(params, inputs)
    cache = pad_self_cache(cache, window)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        cache, logits = decode(params, cache,
                               {"token": tok, "pos": prefix + prompt_len + i})
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
    _sync(dev)
    return {"tokens": torch.stack(out, dim=1).cpu(),
            "prefill_logits": prefill_logits, "last_logits": logits,
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0,
            "params": params, "prompts": prompts, "inputs": inputs,
            "window": window, "pos0": prefix + prompt_len}


def lm_serve(label, run, cfg, batch, prompt_len, gen, seed, dev, needs):
    """One run of ``run`` (``serve.serve``, ``hybrid_steps`` or
    ``media_steps``; random params and prompts from ``seed``) with the
    launch counts set to 0 just before and read just after; then the same
    prefill again, which must be bitwise equal, and one prefill and one
    decode step under the profiler (their launches uncounted). Two peaks
    of device memory: ``init_peak_gb`` over the run, the drawing of the
    params included; ``peak_mem_gb`` over the prefill and decode step
    after it, with the params resident: what serving needs. Returns a
    record; the params are freed."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import api
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed)
    reset_counts()
    r = run(cfg, batch, prompt_len, gen, g, dev)
    launches = read_counts()
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    require_launches(label, launches, needs)
    check_finite(label, r["prefill_logits"], r["last_logits"])
    if r["tokens"].shape != (batch, gen):
        fail(f"{label}: generated {tuple(r['tokens'].shape)} tokens")
    prefill = api.make_prefill_step(cfg)
    inputs = r.get("inputs", {"tokens": r["prompts"]})
    t0 = time.perf_counter()
    again = prefill(r["params"], inputs)[1]    # its cache freed at once
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not torch.equal(again, r["prefill_logits"]):
        fail(f"{label}: the same prefill twice is not bitwise equal")
    out = []
    prof_prefill = profile_path(lambda: out.append(
        prefill(r["params"], inputs)))
    print_profile(f"{label}: one prefill", prof_prefill, 8)
    cache = out[0][0]
    window = r.get("window", prompt_len + gen)
    if cache is None:     # hybrid: decode from a zero cache, at position 0
        cache, pos = api.zero_cache(cfg, ShapeConfig("p", window, batch,
                                                     "decode"), dev), 0
    elif cfg.family == "ssm":     # a recurrent state: nothing to pad
        pos = prompt_len
    else:
        cache, pos = pad_self_cache(cache, window), r.get("pos0", prompt_len)
    decode = api.make_decode_step(cfg)
    tok = torch.argmax(out[0][1], dim=-1)
    del out
    prof_decode = profile_path(lambda: decode(
        r["params"], cache, {"token": tok, "pos": pos}))
    print_profile(f"{label}: one decode step", prof_decode, 8)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del cache
    steps = gen - 1
    rec = {"arch": cfg.arch_id, "n_layers": cfg.n_layers, "batch": batch,
           "prompt_len": prompt_len, "decode_steps": steps,
           "n_params": api.n_params(cfg, window), "prefill_s": r["prefill_s"],
           "prefill_warm_s": warm_s,
           "prefill_tok_s": batch * prompt_len / r["prefill_s"],
           "prefill_warm_tok_s": batch * prompt_len / warm_s,
           "decode_s": r["decode_s"],
           "decode_tok_s": batch * steps / r["decode_s"],
           "peak_mem_gb": peak_gb, "init_peak_gb": init_peak_gb,
           "launches": launches, "profile_prefill": prof_prefill,
           "profile_decode_step": prof_decode}
    print(f"  {label}: {rec['n_params'] / 1e9:.2f} B params; prefill "
          f"{batch}x{prompt_len} in {r['prefill_s']:.3f} s "
          f"({rec['prefill_tok_s']:.0f} tok/s; again, bitwise equal, "
          f"{warm_s:.3f} s, {rec['prefill_warm_tok_s']:.0f} tok/s); "
          f"{steps} decode steps in {r['decode_s']:.3f} s "
          f"({rec['decode_tok_s']:.1f} tok/s); peak device memory "
          f"serving {peak_gb:.2f} GB, with the params' drawing "
          f"{init_peak_gb:.2f} GB; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    del r, again, inputs
    torch.cuda.empty_cache()
    return rec


class plain_kernels:
    """Within the block, ``ops`` runs the plain versions of the two LM
    kernels on the card: the same path, held against the kernels."""

    def __enter__(self):
        from repro_torch.kernels import ops, ref
        self.saved = ops.flash_attention, ops.selective_scan
        ops.flash_attention = ref.flash_attention
        ops.selective_scan = ref.selective_scan

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_attention, ops.selective_scan = self.saved


def _allclose_err(got, want, tol: float) -> float:
    """max(|got - want| / (tol + tol |want|)): at most 1 when every element
    is within tol + tol |want|."""
    return ((got - want).abs() / (tol + tol * want.abs())).max().item()


def lm_correctness(seed, dev):
    """At full width, depth 8 (one Jamba period), f32: Jamba prefill logits
    on the kernels against the same path on the plain versions (B=2,
    T=256); Jamba step-by-step decode from a zero cache against prefill
    (T=64); StableLM prefill of S-1 tokens plus one decode step against
    the full prefill (S=128)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import api
    f32 = dict(n_layers=8, param_dtype="float32", activation_dtype="float32")
    rec = {}
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = get_config("jamba-v0.1-52b").with_overrides(moe=None, **f32)
    params = api.init_params(cfg, g, device=dev)
    prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=g,
                           device=dev)
    _, lk = prefill(params, {"tokens": tokens})
    before = read_counts()
    with plain_kernels():
        _, lp = prefill(params, {"tokens": tokens})
    if read_counts() != before:
        fail("the plain path launched a kernel")
    rec["jamba_kernels_vs_plain"] = compare(
        "Jamba depth 8 f32 prefill logits (B=2, T=256), kernels vs plain",
        lk, lp, LOGIT_TOL)
    T = 64
    _, want = prefill(params, {"tokens": tokens[:, :T]})
    cache = api.zero_cache(cfg, ShapeConfig("t", T, 2, "decode"), dev)
    for t in range(T):
        cache, got = decode(params, cache, {"token": tokens[:, t], "pos": t})
    rec["jamba_decode_vs_prefill"] = e = _allclose_err(got, want, DECODE_TOL)
    print(f"  Jamba depth 8 f32: {T} decode steps from a zero cache vs "
          f"prefill, last position: max |diff| / (2e-3 + 2e-3 |prefill|) "
          f"{e:.3e} {'ok' if e <= 1 else 'DISAGREES'}")
    if e > 1:
        fail("Jamba decode disagrees with prefill")
    del params, cache, lk, lp
    torch.cuda.empty_cache()

    cfg = get_config("stablelm-1.6b").with_overrides(**f32)
    params = api.init_params(cfg, g, device=dev)
    prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)
    S = 128
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=g,
                           device=dev)
    _, want = prefill(params, {"tokens": tokens})
    cache, _ = prefill(params, {"tokens": tokens[:, :-1]})
    cache = SV.pad_cache(cache, S)
    _, got = decode(params, cache, {"token": tokens[:, -1], "pos": S - 1})
    rec["stablelm_decode_vs_prefill"] = e = _allclose_err(got, want,
                                                          DECODE_TOL)
    print(f"  StableLM depth 8 f32: prefill of {S - 1} + one decode step vs "
          f"prefill of {S}: max |diff| / (2e-3 + 2e-3 |prefill|) {e:.3e} "
          f"{'ok' if e <= 1 else 'DISAGREES'}")
    if e > 1:
        fail("StableLM decode disagrees with prefill")
    del params, cache
    torch.cuda.empty_cache()
    return rec


# the rest of the zoo served at its published widths and full depth, in
# bf16: (record key, label, arch, batch, prompt tokens, generated tokens,
# the kernels its path must launch). The dense and ssm ones go through
# repro_torch.launch.serve, the audio and vlm ones through the models.api
# steps (media_steps); RWKV-6's WKV is matmuls, as in the reference, so
# its path launches no kernel
ZOO_SERVE = (
    ("phi3_serve", "Phi-3-medium 14B, CONFIG (40 layers), bf16, "
     "repro_torch.launch.serve", "phi3-medium-14b", 4, 1024, 16,
     ("flash_attention",)),
    ("nemotron_serve", "Nemotron-4 15B, CONFIG (32 layers), bf16, "
     "repro_torch.launch.serve", "nemotron-4-15b", 4, 1024, 16,
     ("flash_attention",)),
    ("gemma_serve", "Gemma 2B, CONFIG (18 layers, head dim 256, MQA), bf16, "
     "repro_torch.launch.serve", "gemma-2b", 4, 1024, 16,
     ("flash_attention",)),
    ("rwkv_serve", "RWKV-6 7B, CONFIG (32 layers), bf16, "
     "repro_torch.launch.serve", "rwkv6-7b", 4, 1024, 16, ()),
    ("whisper_steps", "Whisper large-v3, CONFIG (32 + 32 layers, 1,500 "
     "frames), bf16, prefill and 16 decode steps from the padded cache",
     "whisper-large-v3", 4, 448, 17, ("flash_attention",)),
    ("internvl_steps", "InternVL2-1B, CONFIG (24 layers, 256 patches + 768 "
     "text tokens), bf16, prefill and 16 decode steps from the padded "
     "cache", "internvl2-1b", 4, 768, 17, ("flash_attention",)),
)


def zoo_correctness(seed, dev):
    """Each config of ZOO_SERVE at full width, 2 layers (InternVL2 4,
    Whisper 2 + 2), f32: prefill logits on the kernels against the same
    path on the plain versions (LOGIT_TOL x max|logits|; RWKV-6 has no
    kernel on its path), and decode against prefill (DECODE_TOL): the
    prefill of S - 1 tokens plus one decode step against the prefill of S
    (S = 128, after the 256 patches for InternVL2, with the cross cache
    for Whisper), as the JAX test_decode_matches_full_forward holds them;
    RWKV-6 at S = 64, from a prefill of 48 tokens (both prefills a
    multiple of its 16-step chunk) through 16 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    f32 = dict(param_dtype="float32", activation_dtype="float32")
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    rec = {}
    for key, _, arch, *_ in ZOO_SERVE:
        cfg = get_config(arch)
        depth = dict(n_layers=4 if cfg.family == "vlm" else 2)
        if cfg.family == "audio":
            depth["encoder"] = dataclasses.replace(cfg.encoder, n_layers=2)
        cfg = cfg.with_overrides(**f32, **depth)
        ssm = cfg.family == "ssm"
        S = 64 if ssm else 128
        prefix = cfg.encoder.n_frames if cfg.family == "vlm" else 0
        params = api.init_params(cfg, g, max_seq=prefix + S, device=dev)
        prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(
            cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, S),
                                         generator=g, device=dev)}
        if cfg.family in ("audio", "vlm"):
            batch["frames" if cfg.family == "audio" else "patches"] = \
                torch.randn(2, cfg.encoder.n_frames, cfg.encoder.frontend_dim,
                            generator=g, device=dev)
        name = (f"{arch} f32, {cfg.n_layers} layers"
                + (f" + {cfg.encoder.n_layers} encoder layers"
                   if cfg.family == "audio" else ""))
        _, want = prefill(params, batch)
        r = {}
        if not ssm:
            before = read_counts()
            with plain_kernels():
                _, lp = prefill(params, batch)
            if read_counts() != before:
                fail("the plain path launched a kernel")
            r["kernels_vs_plain"] = compare(
                f"{name} prefill logits (B=2, S={S}), kernels vs plain", want,
                lp, LOGIT_TOL)
            cut = dict(batch, tokens=batch["tokens"][:, :-1])
            cache, _ = prefill(params, cut)
            cache = pad_self_cache(cache, prefix + S)
            _, got = decode(params, cache, {"token": batch["tokens"][:, -1],
                                            "pos": prefix + S - 1})
            how = f"prefill of {S - 1} + one decode step vs prefill of {S}"
        else:
            cache, _ = prefill(params, {"tokens": batch["tokens"][:, :48]})
            for t in range(48, S):
                cache, got = decode(params, cache,
                                    {"token": batch["tokens"][:, t],
                                     "pos": t})
            how = f"prefill of 48 + {S - 48} decode steps vs prefill of {S}"
        r["decode_vs_prefill"] = e = _allclose_err(got, want, DECODE_TOL)
        print(f"  {name}: {how}: max |diff| / (2e-3 + 2e-3 |prefill|) "
              f"{e:.3e} {'ok' if e <= 1 else 'DISAGREES'}")
        if e > 1:
            fail(f"{arch}: decode disagrees with prefill")
        rec[key] = r
        del params, cache, batch
        torch.cuda.empty_cache()
    return rec


# the archs with experts, served in bf16 with random params, each freed
# before the next: (record key, label, arch, overrides, batch, prompt
# tokens, generated tokens, the kernels its path must launch). Moonlight
# and Arctic go through repro_torch.launch.serve, Jamba through the
# models.api steps (hybrid_steps). One card holds Moonlight at full depth
# (56 GB in bf16), Arctic at 2 of its 35 layers (55 GB) and Jamba with its
# experts at one period of 8 layers (27 GB)
MOE_SERVE = (
    ("moonlight_serve", "Moonlight 16B-A3B, CONFIG (48 layers, 64 experts, "
     "top 6), bf16, repro_torch.launch.serve", "moonshot-v1-16b-a3b", {}, 4,
     1024, 16, ("flash_attention",)),
    ("arctic_serve", "Arctic 480B cut to 2 layers (128 experts, top 2, "
     "beside a dense residual MLP), bf16, repro_torch.launch.serve",
     "arctic-480b", {"n_layers": 2}, 4, 1024, 16, ("flash_attention",)),
    ("jamba_moe_steps", "Jamba v0.1 with its experts, one period (8 layers, "
     "4 of them 16 experts, top 2), bf16, prefill and decode steps from a "
     "zero cache", "jamba-v0.1-52b", {"n_layers": 8}, 4, 2048, 17,
     ("flash_attention", "selective_scan")),
)
# the archs with experts held card against CPU at SMOKE, f32 (Arctic and
# Jamba with experts need ~54 GB in f32 even at their least depth): the
# prefill logits, its k and v, and MOE_DECODE_STEPS decode steps' logits
# within LOGIT_TOL x max|logits| (the same routing on both: f32 sums in
# another order move a router probability by ~1e-7)
MOE_SMOKE = ("moonshot-v1-16b-a3b", "arctic-480b", "jamba-v0.1-52b")
MOE_DECODE_STEPS = 3


def moe_correctness(seed, dev):
    """Moonlight at full width, 2 layers, f32: prefill logits on the
    kernels against the same path on the plain versions at the published
    capacity factor (B=2, S=128: each expert keeps 30 of the 1,536
    choices' slots and drops the rest, the same on both paths), and, at
    capacity factor 64 (nothing dropped, as the reference's
    test_decode_matches_full_forward sets it), the prefill of S - 1 tokens
    plus one decode step against the prefill of S. Then MOE_SMOKE card
    against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import api
    g = torch.Generator(device=dev).manual_seed(seed + 27)
    cfg = get_config("moonshot-v1-16b-a3b").with_overrides(
        n_layers=2, param_dtype="float32", activation_dtype="float32")
    params = api.init_params(cfg, g, device=dev)
    S = 128
    tokens = torch.randint(0, cfg.vocab_size, (2, S), generator=g,
                           device=dev)
    prefill = api.make_prefill_step(cfg)
    _, lk = prefill(params, {"tokens": tokens})
    before = read_counts()
    with plain_kernels():
        _, lp = prefill(params, {"tokens": tokens})
    if read_counts() != before:
        fail("the plain path launched a kernel")
    rec = {"moonlight_kernels_vs_plain": compare(
        "Moonlight 16B-A3B f32, 2 layers, prefill logits (B=2, S=128, "
        "capacity factor 1.25), kernels vs plain", lk, lp, LOGIT_TOL)}
    big = cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                     capacity_factor=64.0))
    prefill, decode = api.make_prefill_step(big), api.make_decode_step(big)
    _, want = prefill(params, {"tokens": tokens})
    cache, _ = prefill(params, {"tokens": tokens[:, :-1]})
    _, got = decode(params, SV.pad_cache(cache, S),
                    {"token": tokens[:, -1], "pos": S - 1})
    rec["moonlight_decode_vs_prefill"] = e = _allclose_err(got, want,
                                                           DECODE_TOL)
    print(f"  Moonlight 16B-A3B f32, 2 layers, capacity factor 64: prefill "
          f"of {S - 1} + one decode step vs prefill of {S}: max |diff| / "
          f"(2e-3 + 2e-3 |prefill|) {e:.3e} {'ok' if e <= 1 else 'DISAGREES'}")
    if e > 1:
        fail("Moonlight decode disagrees with prefill")
    del params, cache, lk, lp
    torch.cuda.empty_cache()
    rec["smoke_vs_cpu"] = moe_smoke_vs_cpu(seed, dev)
    return rec


def moe_smoke_vs_cpu(seed: int, dev):
    """Each arch of MOE_SMOKE at SMOKE (f32, its published capacity
    factor) on the card and on the CPU from the same params and prompts:
    the prefill's logits and k, then MOE_DECODE_STEPS decode steps from
    its cache (Jamba's prefill returns none: from a zero cache), each
    step's logits. Returns {arch: the largest max|diff|}."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import api
    rec = {}
    P = 32
    for arch in MOE_SMOKE:
        cfg = get_config(arch, smoke=True)
        prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)
        p_cpu = api.init_params(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, P + MOE_DECODE_STEPS),
                               generator=torch.Generator().manual_seed(seed))
        window = tokens.shape[1]
        outs = []
        for params, d in ((_tree_to(p_cpu, dev), dev), (p_cpu, "cpu")):
            tk = tokens.to(d)
            cache, logits = prefill(params, {"tokens": tk[:, :P]})
            got = {"prefill logits": logits.cpu()}
            if cache is None:
                cache, first = api.zero_cache(cfg, ShapeConfig(
                    "s", window, 2, "decode"), d), 0
            else:
                got["prefill k"] = cache["k"].cpu()
                cache, first = SV.pad_cache(cache, window), P
            for i in range(MOE_DECODE_STEPS):
                cache, logits = decode(params, cache, {
                    "token": tk[:, first + i], "pos": first + i})
                got[f"decode step {i + 1} logits"] = logits.cpu()
            outs.append(got)
        rec[arch] = max(compare(f"{arch} SMOKE f32 {what}, card vs CPU", a,
                                outs[1][what], LOGIT_TOL)
                        for what, a in outs[0].items())
    return rec


def lm_phase(seed, dev):
    """The LM side: both kernels against their plain versions, then the
    serving paths at full width (bf16), then the f32 correctness checks;
    the archs with experts last. Returns (kernel rows, launches by path,
    record)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SV
    from repro_torch.models import api
    g = torch.Generator(device=dev).manual_seed(seed)
    fa_row, fa_recs = check_flash_attention(g, dev)
    ss_row, ss_recs = check_selective_scan(g, dev)
    for r in fa_recs + ss_recs:
        print(f"    {r['case']}: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})  library "
              f"{r['library_ms']}")
    torch.cuda.empty_cache()
    rec = {"flash_attention": fa_recs, "selective_scan": ss_recs}
    rec["stablelm_serve"] = lm_serve(
        "StableLM-2 1.6B, CONFIG, bf16, repro_torch.launch.serve",
        SV.serve, get_config("stablelm-1.6b"), 8, 1024, 32, seed, dev,
        ("flash_attention",))
    rec["jamba_steps"] = lm_serve(
        "Jamba v0.1 without experts, CONFIG (32 layers), bf16, prefill and "
        "decode steps from a zero cache", hybrid_steps,
        get_config("jamba-v0.1-52b").with_overrides(moe=None), 4, 2048, 17,
        seed, dev, ("flash_attention", "selective_scan"))
    rec["correctness"] = lm_correctness(seed, dev)
    for key, label, arch, batch, prompt_len, gen, needs in ZOO_SERVE:
        cfg = get_config(arch)
        run = (SV.serve if cfg.family in ("dense", "ssm") else media_steps)
        rec[key] = lm_serve(label, run, cfg, batch, prompt_len, gen, seed,
                            dev, needs)
    rec["zoo_correctness"] = zoo_correctness(seed, dev)
    for key, label, arch, over, batch, prompt_len, gen, needs in MOE_SERVE:
        cfg = get_config(arch).with_overrides(**over)
        run = SV.serve if cfg.family == "moe" else hybrid_steps
        rec[key] = lm_serve(label, run, cfg, batch, prompt_len, gen, seed,
                            dev, needs)
        rec[key]["n_active_params"] = api.n_active_params(cfg)
    rec["moe_correctness"] = moe_correctness(seed, dev)
    print("  the zoo served in bf16 (prefill s, decode tok/s, serving peak "
          "GB (with the params' drawing), launches of flash_attention):")
    for key, *_ in ZOO_SERVE + MOE_SERVE:
        z = rec[key]
        print(f"    {z['arch']} ({z['n_layers']} layers): "
              f"{z['prefill_s']:.3f} s, "
              f"{z['decode_tok_s']:.1f} tok/s, {z['peak_mem_gb']:.2f} GB "
              f"({z['init_peak_gb']:.2f} GB), "
              f"{z['launches']['flash_attention']}")
    paths = {"stablelm_serve": rec["stablelm_serve"]["launches"],
             "jamba_steps": rec["jamba_steps"]["launches"],
             **{key: rec[key]["launches"]
                for key, *_ in ZOO_SERVE + MOE_SERVE}}
    return [fa_row, ss_row], paths, rec


class TimedStage:
    """A canonical stage of the recipe, recording its wall time to the
    device's end."""

    def __init__(self, name: str, walls: dict, dev):
        from repro_torch.api import STAGE_REGISTRY
        self.name, self.walls, self.dev = name, walls, dev
        self.inner = STAGE_REGISTRY[name]()

    def run(self, ctx):
        _sync(self.dev)
        t0 = time.perf_counter()
        ctx = self.inner.run(ctx)
        _sync(self.dev)
        self.walls[self.name] = time.perf_counter() - t0
        return ctx


def rel_err(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return ((got - want).abs().max() / want.abs().max()).item()


def recipe_backend_vs_cpu(cfg, r, labels, seed: int, dev) -> dict:
    """The recipe run's §4.1 backend on the card against the CPU (see
    BACKEND_TOL and LDA_LEAD_TOL)."""
    from repro_torch.api import artifacts as AR
    from repro_torch.data.speech import make_trials
    iv = torch.from_numpy(r.ivectors)
    a, b, _ = make_trials(labels, np.arange(len(labels)),
                          np.random.default_rng(seed))
    art_c = r.backend.to("cpu")
    xl_g = AR.apply_backend(r.backend, iv.to(dev)).cpu()
    xl_c = AR.apply_backend(art_c, iv)
    out = {"projected": rel_err(xl_g, xl_c),
           "scores": rel_err(AR.score_trials(r.backend, xl_g, a, b),
                             AR.score_trials(art_c, xl_c, a, b))}
    print(f"  one backend, card vs CPU: projected vectors "
          f"{out['projected']:.3e}, trial scores {out['scores']:.3e} x "
          f"max|value| (tolerance {BACKEND_TOL})")
    if max(out["projected"], out["scores"]) > BACKEND_TOL:
        fail("recipe: the backend on the card and on the CPU disagree")
    eer_c, art_t = AR.evaluate_ivectors(cfg, iv, labels, seed)
    xl_t = AR.apply_backend(art_t, iv)
    k = RECIPE_SPEAKERS - 1
    sign = torch.sign((xl_t[:, :k] * xl_c[:, :k]).sum(0))
    out.update(lead=rel_err(xl_t[:, :k] * sign, xl_c[:, :k]),
               retrained_scores=rel_err(AR.score_trials(art_t, xl_t, a, b),
                                        AR.score_trials(art_c, xl_c, a, b)),
               eer_cpu=eer_c)
    print(f"  chain trained on the CPU from the card's i-vectors: leading "
          f"{k} LDA columns {out['lead']:.3e} x max|value| up to sign "
          f"(tolerance {LDA_LEAD_TOL}); trial scores "
          f"{out['retrained_scores']:.3e} x max|score|; EER {eer_c:.4f} "
          f"(card {r.eer:.4f}, tolerance {EER_TOL})")
    if out["lead"] > LDA_LEAD_TOL:
        fail("recipe: the LDA trained on the CPU disagrees with the card's")
    if abs(eer_c - r.eer) > EER_TOL:
        fail(f"recipe: EER {r.eer} on the card, {eer_c} from the CPU chain "
             f"(tolerance {EER_TOL})")
    return out


def recipe_phase(cfg, seed: int, dev):
    """The staged recipe at full width on the card: the port's speech
    generator (its default distributions) draws RECIPE_SPEAKERS x
    RECIPE_UTTS utterances of RECIPE_FRAMES frames, normalised over the
    corpus; ``train_ubm`` (top-20, 2 + 2 iterations, as in
    phase 5: the recipe's ubm stage keeps the reference's top_k=0, K = C,
    which scatters 2,048 one-slot slices per chunk) makes the UBM, passed
    in through the (feats, labels, ubm) triple so that the ubm stage is
    skipped, as the JAX recipe skips it; ``IVectorRecipe.run`` trains 3
    iterations, fits the backend, scores the trials and saves a bundle in
    a temporary directory; ``IVectorExtractor.from_bundle`` serves 32 of
    the utterances. Returns (record, launches by path)."""
    import tempfile
    from repro_torch.api import Bundle, IVectorRecipe
    from repro_torch.core import ubm as U
    from repro_torch.data.speech import SpeechDataConfig, build_dataset
    from repro_torch.serving import IVectorExtractor, ServingConfig
    C, D = cfg.n_components, cfg.feat_dim
    rec = {"speakers": RECIPE_SPEAKERS, "utts_per_speaker": RECIPE_UTTS,
           "frames_per_utt": RECIPE_FRAMES}
    data_cfg = SpeechDataConfig(feat_dim=D, n_speakers=RECIPE_SPEAKERS,
                                utts_per_speaker=RECIPE_UTTS,
                                frames_per_utt=RECIPE_FRAMES, seed=seed)
    _sync(dev)
    t0 = time.perf_counter()
    feats, labels = build_dataset(data_cfg, device=dev)
    # mean and variance normalisation over the corpus, as a front end
    # normalises MFCCs: on the raw frames (|x|^2 in the hundreds) the
    # augmented M-step's f32 Σ update goes indefinite on the components
    # that own a handful of frames, and the next Cholesky fails
    flat = feats.reshape(-1, D)
    feats = (feats - flat.mean(dim=0)) / flat.std(dim=0)
    _sync(dev)
    rec["data_s"] = time.perf_counter() - t0
    paths = {}
    reset_counts()
    t0 = time.perf_counter()
    ubm = U.train_ubm(feats.reshape(-1, D), C,
                      torch.Generator().manual_seed(seed), diag_iters=2,
                      full_iters=2, top_k=cfg.posterior_top_k, device=dev)
    _sync(dev)
    rec["train_ubm_s"] = time.perf_counter() - t0
    paths["recipe_ubm"] = read_counts()
    print(f"  data: {feats.shape[0]} utterances x {RECIPE_FRAMES} frames "
          f"(data/speech.py) {rec['data_s']:.2f} s; train_ubm (top-20) "
          f"{rec['train_ubm_s']:.2f} s")

    walls = {}
    recipe = IVectorRecipe.from_config(
        cfg, stages=[TimedStage(n, walls, dev)
                     for n in IVectorRecipe.DEFAULT_STAGES], device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        r = recipe.run(data=(feats, labels, ubm), seed=seed, n_iters=3,
                       bundle_dir=Path(tmp) / "bundle")
        _sync(dev)
        rec["run_s"] = time.perf_counter() - t0
        paths["recipe"] = read_counts()
        require_launches("recipe", paths["recipe"],
                         ("gmm_rescore", "bw_stats", "tvm_estep_l_train",
                          "tvm_estep_a"))
        rec["stage_s"] = dict(walls)
        # what run does after its stages: the result and the bundle save
        rec["bundle_save_s"] = rec["run_s"] - sum(walls.values())
        files = [f for f in Path(r.bundle_path).rglob("*") if f.is_file()]
        rec["bundle_bytes"] = sum(f.stat().st_size for f in files)
        rec["eer"] = r.eer
        print("  recipe.run: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in walls.items())
            + f"; bundle save {rec['bundle_save_s']:.2f} s "
            f"({rec['bundle_bytes'] / 1e6:.1f} MB); launches "
            f"{paths['recipe']}")
        print(f"  EER {r.eer:.4f} over 20,000 trials "
              f"({RECIPE_SPEAKERS} speakers)")
        if not 0.0 <= r.eer <= 0.5:
            fail(f"recipe: EER {r.eer} outside [0, 0.5]")
        rec["bundle_load_s"] = host_seconds(
            dev, lambda: Bundle.load(r.bundle_path, device=dev))
        requests = [feats[(20 * i) % len(labels), :128 + (97 * i) % 385]
                    .cpu().numpy()
                    for i in range(32)]
        iv_mem = IVectorExtractor(cfg, r.tv.model, r.tv.ubm,
                                  ServingConfig(), device=dev).extract(
                                      requests)
        t0 = time.perf_counter()
        ex_b = IVectorExtractor.from_bundle(r.bundle_path, ServingConfig(),
                                            device=dev)
        _sync(dev)
        rec["from_bundle_s"] = time.perf_counter() - t0
    iv_b, paths["from_bundle"], rec["from_bundle_wall_s"] = drive(
        ex_b, requests, "from_bundle session")
    require_launches("from_bundle", paths["from_bundle"],
                     ("gmm_rescore", "tvm_estep_l"))
    print(f"  Bundle.load {rec['bundle_load_s']:.2f} s; from_bundle "
          f"(load + session set-up) {rec['from_bundle_s']:.2f} s")
    check_ivectors(iv_b, len(requests), cfg.ivector_dim, "from_bundle")
    if not np.array_equal(iv_b, iv_mem):
        fail("from_bundle i-vectors are not bitwise the in-memory "
             "session's")
    print("  from_bundle i-vectors are bitwise the in-memory session's")
    rec["vs_cpu"] = recipe_backend_vs_cpu(cfg, r, labels, seed, dev)
    return rec, paths


# ---------------------------------------------------------------------------
# Phase 8: streaming sessions, admission, rollout (serving/session.py,
# guard.py, rollout.py) at full width
# ---------------------------------------------------------------------------

# the first STREAMS requests of phase 3 that hold STREAM_FRAMES frames, cut
# to that length and streamed in CHUNK-frame chunks (serve_ivector's
# default; a 40-frame chunk pads to the 64-frame bucket, a 20-frame one to
# 32): 32 x 12 = 384 chunks. The child process of the kill -9 drill is
# killed after KILL_AFTER acknowledged chunks.
STREAMS, STREAM_FRAMES, CHUNK = 32, 480, 40
CHUNK_MIN_BUCKET = 32
COMPACT_BYTES = 64 << 20      # above the 32 sessions' 19 MB live set
KILL_AFTER = 150


def session_config(journal_dir=None):
    from repro_torch.serving import SessionConfig
    return SessionConfig(chunk_min_bucket=CHUNK_MIN_BUCKET,
                         journal_dir=None if journal_dir is None
                         else str(journal_dir),
                         journal_compact_bytes=COMPACT_BYTES)


def chunk_of(streams, s: int, k: int):
    return streams[s, k * CHUNK:(k + 1) * CHUNK]


def sid_of(s: int) -> str:
    return f"stream-{s}"


def serve_child(workdir: Path) -> int:
    """The kill -9 drill's child: serves every stream's chunks round-robin
    through a journaled `SessionStore` on the bundle of ``workdir``, on
    the parent's device, and acknowledges each applied chunk on stdout
    ("<sid> <seq>") after the journal holds it. The parent kills it
    mid-stream."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.serving import IVectorExtractor, SessionStore
    streams = np.load(workdir / "streams.npy")
    dev = torch.device((workdir / "device.txt").read_text())
    ex = IVectorExtractor.from_bundle(workdir / "bundle", device=dev)
    store = SessionStore(ex, session_config(workdir / "journal"))
    for k in range(streams.shape[1] // CHUNK):
        for s in range(streams.shape[0]):
            _, info = store.update(sid_of(s), chunk_of(streams, s, k))
            print(f"{info.sid} {info.seq}", flush=True)
    print("done", flush=True)
    return 0


def start_child(workdir: Path):
    err = open(workdir / "child.err", "wb")
    try:
        return subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--serve-child",
             str(workdir)], stdout=subprocess.PIPE, stderr=err)
    finally:
        err.close()


def read_acks(proc, n: int, timeout: float) -> dict:
    """Read the child's acknowledgements until ``n`` chunks are acked;
    returns {sid: highest acked seq}. Fails if the child ends first or
    the time runs out."""
    fd, buf, acks = proc.stdout.fileno(), b"", {}
    deadline = time.monotonic() + timeout
    while sum(1 for _ in buf.splitlines()) < n:
        left = deadline - time.monotonic()
        if left <= 0:
            fail(f"kill -9 drill: the child acked {len(buf.splitlines())} "
                 f"chunks in {timeout:.0f} s")
        ready, _, _ = select.select([fd], [], [], left)
        if ready:
            data = os.read(fd, 1 << 16)
            if not data:
                fail("kill -9 drill: the child ended before the kill")
            buf += data
    for line in buf.splitlines()[:n]:
        sid, seq = line.decode().split()
        acks[sid] = max(acks.get(sid, 0), int(seq))
    return acks


def kill_drill(proc, workdir: Path, ex, streams) -> dict:
    """SIGKILL the serving child after KILL_AFTER acknowledged chunks, then
    restore its journal in this process: every acknowledged chunk is
    there, and each session's n, f are bitwise those of a store here fed
    that session's chunks up to its restored seq."""
    from repro_torch.serving import SessionStore
    t0 = time.perf_counter()
    try:
        acks = read_acks(proc, KILL_AFTER, 240.0)
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        proc.stdout.close()
    wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = SessionStore(ex, session_config(workdir / "journal"))
    restore_s = time.perf_counter() - t0
    ref = SessionStore(ex, session_config())
    restored = {sid: store.session(sid).seq for sid in acks
                if sid in store}
    for sid, acked in acks.items():
        if restored.get(sid, 0) < acked:
            fail(f"kill -9 drill: {sid} acked seq {acked}, restored "
                 f"{restored.get(sid)}")
    for s in range(streams.shape[0]):
        sid = sid_of(s)
        if sid not in store:
            continue
        seq = store.session(sid).seq
        for k in range(seq):
            ref.update(sid, chunk_of(streams, s, k), emit=False)
        if not (np.array_equal(store.session(sid).n, ref.session(sid).n)
                and np.array_equal(store.session(sid).f,
                                   ref.session(sid).f)):
            fail(f"kill -9 drill: {sid} restored at seq {seq} is not "
                 "bitwise the store fed the same chunks")
    rec = {"acked": KILL_AFTER, "restored_chunks": sum(
        store.session(sid_of(s)).seq for s in range(streams.shape[0])
        if sid_of(s) in store),
        "sessions": len(store), "torn": store.stats["journal_torn"],
        "restore_s": restore_s, "child_rc": proc.returncode,
        "wait_s": wait_s}
    print(f"  kill -9 drill: child killed after {KILL_AFTER} acknowledged "
          f"chunks (rc {proc.returncode}); {rec['sessions']} sessions, "
          f"{rec['restored_chunks']} chunks restored in {restore_s:.3f} s "
          f"(torn tail {rec['torn']}); every acked chunk present, n and f "
          f"bitwise the parent's replay; waited {wait_s:.1f} s for the "
          "child")
    store.close_store()
    return rec


def stream_through_queue(store, q, streams, snapshot):
    """Every chunk of every stream through the admission queue, round-robin
    (a stream's first chunk as 'first', later ones as 'refine'), drained
    at ``batch_budget()`` each tick. A chunk shed at submit (QueueFull) or
    preempted in the queue is submitted again, so each is applied once.
    ``snapshot()`` runs once, after the tick that brings the applied
    chunks to 6 a stream on average. Returns the record and the applied
    (stream, chunk) order."""
    from repro_torch.serving import QueueFull
    S, n_chunks = streams.shape[0], streams.shape[1] // CHUNK
    todo = {s: list(range(n_chunks)) for s in range(S)}
    inflight, applied, arrived, first_iv = {}, [], {}, {}
    full = preempted = expired = 0
    snap_s, snap_at = 0.0, None
    t0 = time.perf_counter()
    while len(applied) < S * n_chunks:
        for s in range(S):
            if not todo[s]:
                continue
            k = todo[s][0]
            # a stream arrives with its first submission attempt; a
            # request is done at its submit time + its queue wait (the
            # queue's clock, time.monotonic, stopped right after its
            # update)
            arrived.setdefault(s, time.monotonic())
            try:
                rid = q.submit(chunk_of(streams, s, k),
                               kind="first" if k == 0 else "refine",
                               sid=sid_of(s))
            except QueueFull:
                full += 1
                continue
            todo[s].pop(0)
            inflight[rid] = (s, k, time.monotonic())
        for rid, r in q.drain(q.batch_budget()).items():
            s, k, sub = inflight.pop(rid)
            if r.ivector is None:
                preempted += r.preempted
                expired += not r.preempted
                todo[s].insert(0, k)
                continue
            applied.append((s, k))
            first_iv.setdefault(s, sub + r.wait_s - arrived[s])
        if snap_at is None and len(applied) >= 6 * S:
            t1 = time.perf_counter()
            snapshot()
            snap_at = len(applied)
            snap_s = time.perf_counter() - t1
    wall = time.perf_counter() - t0 - snap_s
    st = q.stats
    if not (st["shed_refine"] > 0 and st["shed_full"] > 0):
        fail(f"admission: no refine preemption or no full-queue shed: {st}")
    if (preempted != st["shed_refine"] or full != st["shed_full"]
            or expired != st["shed_deadline"]
            or st["served"] != S * n_chunks
            or st["submitted"] != S * n_chunks + preempted + expired):
        fail(f"admission: shed requests not accounted for: {st}, "
             f"preempted {preempted}, full {full}, expired {expired}")
    tf = sorted(first_iv.values())
    return {"chunks": len(applied), "wall_s": wall,
            "chunks_per_s": len(applied) / wall,
            "ttfi_p50_s": tf[len(tf) // 2], "ttfi_max_s": tf[-1],
            "queue": dict(st)}, applied, snap_at


def chunk_kernel_checks(ex, streams, K: int) -> dict:
    """The session path's kernels at its shapes, each against its plain
    version: a 40-frame chunk padded to the 64-frame bucket and a 20-frame
    one padded to 32 (zero rows, as the store pads them) through
    gmm_rescore, gmm_align and gmm_loglik, and the E-step's stream form at
    M = 1 (a chunk's occupancies against the packed precompute)."""
    from repro_torch.core import alignment as AL
    from repro_torch.core import engine as EN
    from repro_torch.core import ubm as U
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import gmm_rescore as GR
    from repro_torch.kernels import ref
    from repro_torch.kernels import tvm_estep as TE
    dev = ex.device
    pack = ex._pack
    const, lin, P = pack.pre
    C, D = lin.shape
    linT, Pf = lin.T.contiguous(), P.reshape(C, D * D).contiguous()
    dconst, dlin, dquad = (t.contiguous() for t in U.diag_coeffs(pack.diag))
    out = {}
    for real, bucket in ((CHUNK, 64), (CHUNK // 2, 32)):
        x = torch.zeros(bucket, D, device=dev)
        x[:real] = torch.from_numpy(chunk_of(streams, 0, 1)[:real]).to(dev)
        _, sel = AL.preselect(pack.diag, x, K)
        sel = sel.contiguous()
        t = {}
        t["gmm_rescore_err"] = compare(
            f"gmm_rescore chunk [{bucket}x{K}]", GR.gmm_rescore(
                x, sel, pack.rescore_A),
            ref.gmm_rescore(x, sel, const, linT, Pf))
        t["gmm_rescore_ms"] = cuda_ms(
            lambda: GR.gmm_rescore(x, sel, pack.rescore_A), 50)
        t["gmm_align_err"], _ = held_align(
            f"chunk [{bucket}x{D}]", x, dconst, dlin, dquad, pack.align_A, K)
        from repro_torch.kernels import gmm_align as GA
        t["gmm_align_ms"] = cuda_ms(lambda: GA.gmm_align(
            x, dconst, dlin, dquad, pack.align_A, K), 50)
        t["gmm_loglik_err"] = compare(
            f"gmm_loglik chunk [{bucket}x{D}]",
            GL.gmm_loglik(x, const, linT, Pf),
            ref.gmm_loglik(x, const, linT, Pf))
        t["gmm_loglik_ms"] = cuda_ms(
            lambda: GL.gmm_loglik(x, const, linT, Pf), 50)
        out[bucket] = t
    mask = torch.ones(CHUNK, device=dev)
    feats = torch.from_numpy(chunk_of(streams, 0, 1)).to(dev)
    n1 = EN.session_stats(ex._spec, pack, feats, mask)[0][None]
    Up = ex._tv_pre.U
    if TE.form(torch.float32, 1, C, Up.shape[1]) != "stream":
        fail("the M = 1 solve does not take the stream form")
    out["stream_err"] = compare(
        f"tvm_estep_l [1x{C}] @ [{C}x{Up.shape[1]}], stream form",
        TE.tvm_estep_l(n1, Up), ref.tvm_estep_l(n1, Up))
    out["stream_ms"] = cuda_ms(lambda: TE.tvm_estep_l(n1, Up), 50)
    return out


def streaming_phase(cfg, ubm, model, utts, seed: int, dev):
    """Phase 8: the phase-3 system saved as a `Bundle` and served through
    `from_bundle`; STREAMS streams of CHUNK-frame chunks through
    `AdmissionQueue(max_pending=16, store=SessionStore(...))` with a
    journal; crash restore, torn tail, a real kill -9, the demotion
    ladder, rollout and admission checks. Returns (record, launches by
    path)."""
    import shutil
    import tempfile
    from repro_torch.api import Bundle
    from repro_torch.distributed import fault_tolerance as FT
    from repro_torch.serving import (AdmissionQueue, IVectorExtractor,
                                     RolloutController, ServingConfig,
                                     SessionJournal, SessionStore)
    from repro_torch.serving import rollout as RO
    picked = [u[:STREAM_FRAMES] for u in utts
              if u.shape[0] >= STREAM_FRAMES][:STREAMS]
    streams = np.stack(picked).astype(np.float32)
    S, n_chunks = streams.shape[0], STREAM_FRAMES // CHUNK
    rec, paths = {"streams": S, "chunks_per_stream": n_chunks}, {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_"))
    proc = None
    try:
        child = tmp / "child"
        child.mkdir()
        t0 = time.perf_counter()
        Bundle(cfg=cfg, ubm=ubm, model=model).save(child / "bundle")
        rec["bundle_save_s"] = time.perf_counter() - t0
        np.save(child / "streams.npy", streams)
        (child / "device.txt").write_text(str(dev))
        # the child takes seconds to reach the card: it starts now and is
        # read after the work below, none of it timed as the main path
        proc = start_child(child)
        bundle_a = child / "bundle"
        # the rollout candidate: a second synthetic system
        ubm_b, model_b, _ = synthetic_system(cfg, seed + 1, dev)
        Bundle(cfg=cfg, ubm=ubm_b, model=model_b).save(tmp / "bundle_b")
        del ubm_b, model_b
        t0 = time.perf_counter()
        ex = IVectorExtractor.from_bundle(bundle_a, ServingConfig(),
                                          device=dev)
        _sync(dev)
        rec["from_bundle_s"] = time.perf_counter() - t0
        rec["kernels"] = chunk_kernel_checks(ex, streams,
                                             cfg.posterior_top_k)
        rec["kill"] = kill_drill(proc, child, ex, streams)
        proc = None

        # the main path: the queue-driven streams
        store = SessionStore(ex, session_config(tmp / "journal"))
        walls = []
        update = store.update

        def timed_update(sid, chunk, emit=True):
            t1 = time.perf_counter()
            out = update(sid, chunk, emit)
            walls.append(time.perf_counter() - t1)
            return out

        store.update = timed_update
        q = AdmissionQueue(ex, max_pending=16, store=store)
        snap = {}

        def snapshot():
            # a copy of the journal dir, opened by a second store: the
            # in-process crash restore
            shutil.copytree(tmp / "journal", tmp / "snap")
            t1 = time.perf_counter()
            snap["store"] = SessionStore(ex, session_config(tmp / "snap"))
            snap["restore_s"] = time.perf_counter() - t1
            snap["want"] = {sid: (s.n.copy(), s.f.copy(), s.seq)
                            for sid, s in store._sessions.items()}

        reset_counts()
        run, applied, snap_at = stream_through_queue(store, q, streams,
                                                     snapshot)
        paths["stream"] = read_counts()
        require_launches("streaming", paths["stream"],
                         ("gmm_rescore", "tvm_estep_l"))
        walls.sort()
        run["chunk_wall_p50_s"] = walls[len(walls) // 2]
        run["chunk_wall_p99_s"] = walls[min(len(walls) - 1,
                                            int(0.99 * len(walls)))]
        rec["run"] = run
        if store.stats["degradations"]:
            fail(f"streaming store degraded: {store.stats}")
        health = q.health()
        if not health["ok"]:
            fail(f"streaming: health {health}")
        j = store._journal
        s0 = store.session(sid_of(0))
        rec["journal"] = {
            "record_bytes": len(j._frame(j._encode(store._record(s0)))),
            "records_appended": run["chunks"],
            "compactions": store.stats["compactions"],
            "file_bytes": store.stats["journal_bytes"],
            "restore_s": snap["restore_s"]}
        rec["journal"]["appended_mb"] = (rec["journal"]["record_bytes"]
                                         * run["chunks"] / 1e6)
        print(f"  streaming: {run['chunks']} chunks of {CHUNK} frames from "
              f"{S} streams in {run['wall_s']:.3f} s: "
              f"{run['chunks_per_s']:.1f} chunks/s; time to first i-vector "
              f"p50 {run['ttfi_p50_s'] * 1e3:.1f} ms, max "
              f"{run['ttfi_max_s'] * 1e3:.1f} ms; per-chunk wall p50 "
              f"{run['chunk_wall_p50_s'] * 1e3:.2f} ms, p99 "
              f"{run['chunk_wall_p99_s'] * 1e3:.2f} ms (host clock); "
              f"launches {paths['stream']}")
        print(f"  admission: {run['queue']}")
        print(f"  journal: {rec['journal']['record_bytes']} bytes a record, "
              f"{rec['journal']['appended_mb']:.1f} MB appended, "
              f"{rec['journal']['compactions']} compactions, file "
              f"{rec['journal']['file_bytes'] / 1e6:.1f} MB; restore of "
              f"{len(snap['want'])} sessions {snap['restore_s']:.3f} s")
        k = rec["kernels"]
        print(f"  kernels at the chunk's shapes (ms; chunk wall p50 "
              f"{run['chunk_wall_p50_s'] * 1e3:.2f}): gmm_rescore "
              f"{k[64]['gmm_rescore_ms']:.4f} / {k[32]['gmm_rescore_ms']:.4f}"
              f" (64 / 32 frames), gmm_align {k[64]['gmm_align_ms']:.4f} / "
              f"{k[32]['gmm_align_ms']:.4f}, gmm_loglik "
              f"{k[64]['gmm_loglik_ms']:.4f} / {k[32]['gmm_loglik_ms']:.4f},"
              f" stream form at M = 1 {k['stream_ms']:.4f}")

        # incremental against batch
        final = np.stack([store.solve(sid_of(s)) for s in range(S)])
        batch = ex.extract(list(streams))
        check_ivectors(final, S, cfg.ivector_dim, "streamed")
        d_ib = float(np.abs(final - batch).max())
        rec["stream_vs_batch_max_diff"] = d_ib
        print(f"  streamed vs batch extract of the whole streams: max "
              f"|diff| {d_ib:.3e} (tolerance {IVEC_TOL})")
        if d_ib > IVEC_TOL:
            fail("streamed i-vectors disagree with batch extraction")

        # in-process crash restore, continued to the end
        c = snap["store"]
        for sid, (n, f, seq) in snap["want"].items():
            s = c.session(sid)
            if not (s.seq == seq and np.array_equal(s.n, n)
                    and np.array_equal(s.f, f)):
                fail(f"crash restore: {sid} is not bitwise the live store's")
        for s, kk in applied[snap_at:]:
            c.update(sid_of(s), chunk_of(streams, s, kk), emit=False)
        for s in range(S):
            if not np.array_equal(c.solve(sid_of(s)), final[s]):
                fail(f"crash restore: {sid_of(s)}'s final i-vector is not "
                     "bitwise the uninterrupted store's")
        print(f"  crash restore after {snap_at} chunks: {len(snap['want'])} "
              "sessions bitwise; after the remaining chunks every "
              "i-vector bitwise the uninterrupted store's")
        c.close_store()

        # torn tail: one more record on a copy, then torn mid-record
        store.close_store()
        shutil.copytree(tmp / "journal", tmp / "torn")
        # (no compaction on this append: the torn record must be the
        # session's second newest)
        e = SessionStore(ex, dataclasses.replace(
            session_config(tmp / "torn"), journal_compact_bytes=1 << 40))
        e.update(sid_of(0), chunk_of(streams, 0, 0), emit=False)
        e_seq = e.session(sid_of(0)).seq
        e.close_store()
        wal = tmp / "torn" / "wal.log"
        with open(wal, "r+b") as fh:
            fh.truncate(wal.stat().st_size - 1000)
        torn = SessionStore(ex, session_config(tmp / "torn"))
        t0s = torn.session(sid_of(0))
        if (torn.stats["journal_torn"] != 1 or t0s.seq != e_seq - 1
                or not np.array_equal(t0s.n, s0.n)
                or len(torn) != S):
            fail(f"torn tail: {torn.stats}, seq {t0s.seq} (want "
                 f"{e_seq - 1})")
        torn.close_store()
        print(f"  torn tail: journal_torn 1, {sid_of(0)} restored one "
              f"chunk behind (seq {e_seq - 1}), bitwise")

        # the demotion ladder on a fused store: 4 chunks fused, then the
        # fused kernel fails (-> sparse), then sparse too (-> dense)
        ex_f = IVectorExtractor(cfg.with_overrides(rescore="fused"),
                                ex.model, ex.ubm, ServingConfig(),
                                device=dev)
        sf = SessionStore(ex_f, session_config())
        reset_counts()
        modes = []
        for kk in range(n_chunks):
            if kk == 4:
                if sf.stats["degradations"] or sf._live.mode != "fused":
                    fail(f"fused store degraded un-injected: {sf.stats}")
                sf._chaos_fail_modes = {"fused"}
            if kk == 8:
                sf._chaos_fail_modes = {"fused", "sparse"}
            for s in (0, 1):
                sf.update(sid_of(s), chunk_of(streams, s, kk))
            modes.append(sf._live.mode)
        paths["stream_demotion"] = read_counts()
        require_launches("demotion", paths["stream_demotion"],
                         ("gmm_align", "gmm_rescore", "gmm_loglik",
                          "tvm_estep_l"))
        if modes != ["fused"] * 4 + ["sparse"] * 4 + ["dense"] * 4 or \
                sf.stats["degradations"] != 2:
            fail(f"demotion: modes {modes}, {sf.stats}")
        d_dm = max(float(np.abs(sf.solve(sid_of(s)) - final[s]).max())
                   for s in (0, 1))
        rec["demotion_max_diff"] = d_dm
        print(f"  demotion: fused -> sparse -> dense, 2 degradations for "
              f"2 injected failures; i-vectors vs the sparse store max "
              f"|diff| {d_dm:.3e} (tolerance {IVEC_TOL}); launches "
              f"{paths['stream_demotion']}")
        if d_dm > IVEC_TOL:
            fail("demotion: the demoted store disagrees with the sparse one")
        del ex_f, sf

        # rollout
        shadow = [streams[s] for s in range(4)]
        rec["model_hash_s"] = host_seconds(dev, lambda: RO._model_hash(ex))
        rc = RolloutController(ex)
        rep = rc.roll(bundle_a, shadow_utts=shadow)
        if rep.outcome != "swapped" or not rep.parity["bit_exact"]:
            fail(f"rollout, identical bundle: {rep.outcome} {rep.reason}")
        roll_s = {"same": rep.elapsed_s}
        del rc, rep
        s1, s2 = (SessionStore(ex, session_config()) for _ in range(2))
        for kk in range(6):
            for s in range(4):
                for st_ in (s1, s2):
                    st_.update(sid_of(s), chunk_of(streams, s, kk),
                               emit=False)
        rc = RolloutController(ex, store=s1)
        rep = rc.roll(tmp / "bundle_b", shadow_utts=shadow, policy="migrate")
        roll_s["new_migrate"] = rep.elapsed_s
        if (rep.outcome != "swapped" or rep.sessions["migrated"] != 4
                or rep.parity["same_content"]):
            fail(f"rollout, new bundle: {rep.outcome} {rep.reason} "
                 f"{rep.sessions}")
        if np.array_equal(s1.solve(sid_of(0)), s2.solve(sid_of(0))):
            fail("rollout: the migrated session solves as before the swap")
        if not rc.rollback() or rc.live is not ex:
            fail("rollout: rollback did not restore the live extractor")
        for s in range(4):
            a, _ = s1.update(sid_of(s), chunk_of(streams, s, 6))
            b, _ = s2.update(sid_of(s), chunk_of(streams, s, 6))
            if not np.array_equal(a, b):
                fail("rollout: after rollback the next i-vector is not "
                     "bitwise a store's that never swapped")
        rep = rc.roll(tmp / "bundle_b", shadow_utts=shadow, policy="drain")
        roll_s["new_drain"] = rep.elapsed_s
        s1.update("new-session", chunk_of(streams, 5, 0))
        if (rep.outcome != "swapped"
                or rep.sessions != {"migrated": 0, "pinned_to_old": 4}
                or s1.draining() != 4
                or s1.session("new-session").binding is
                s1.session(sid_of(0)).binding):
            fail(f"rollout, drain: {rep.outcome} {rep.sessions}")
        FT.corrupt_checkpoint(next((tmp / "bundle_b").glob("step_*")))
        rep = RolloutController(ex).roll(tmp / "bundle_b",
                                         shadow_utts=shadow)
        roll_s["corrupt"] = rep.elapsed_s
        if rep.outcome != "rejected" or "shadow-load failed" not in \
                rep.reason:
            fail(f"rollout, corrupt bundle: {rep.outcome} {rep.reason}")
        rec["roll_s"] = roll_s
        print("  rollout: identical bundle bit_exact and swapped; new "
              "bundle swapped (4 migrated), rollback bitwise a store that "
              "never swapped; drain kept 4 sessions pinned; byte-flipped "
              "bundle rejected at shadow-load. roll s: "
              + ", ".join(f"{k} {v:.2f}" for k, v in roll_s.items())
              + f"; _model_hash {rec['model_hash_s']:.3f} s; bundle save "
              f"{rec['bundle_save_s']:.2f} s, from_bundle "
              f"{rec['from_bundle_s']:.2f} s")
        del rc, s1, s2

        # the device's share of one chunk's wall, and the chunk's wall
        # split into its three host-side steps (medians of 20)
        sp = SessionStore(ex, session_config())
        sp.update("p", chunk_of(streams, 0, 0))
        prof = profile_path(lambda: sp.update("p", chunk_of(streams, 0, 1)))
        print_profile("streamed chunk (update + solve)", prof, 8)
        rec["profile_chunk"] = prof
        D = streams.shape[2]
        feats = np.zeros((64, D), np.float32)
        feats[:CHUNK] = chunk_of(streams, 0, 2)
        mask = np.zeros((64,), np.float32)
        mask[:CHUNK] = 1.0
        jr, _ = SessionJournal.open(tmp / "split" / "wal.log", sp.C, D)
        rec_p = sp._record(sp.session("p"))

        def med_ms(fn):
            return 1e3 * float(np.median([host_seconds(dev, fn)
                                          for _ in range(20)]))

        split = {"align_stats_copy_ms": med_ms(
                     lambda: sp._run_chunk(sp._live, feats, mask)),
                 "solve_ms": med_ms(lambda: sp.solve("p")),
                 "journal_append_ms": med_ms(lambda: jr.append(rec_p))}
        jr.close()
        rec["chunk_split"] = split
        print("  one chunk's steps (host clock, median of 20): "
              + ", ".join(f"{k[:-3]} {v:.2f} ms" for k, v in split.items()))
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    return rec, paths


# ---------------------------------------------------------------------------
# Phase 9: the supervised trainer and its fault drill at full width
# ---------------------------------------------------------------------------

SUP_UTTS, SUP_FRAMES, SUP_STEPS = 128, 512, 3


class _Timed:
    """Wraps callables so that each call's synchronised host seconds are
    recorded under a name (restored by ``undo``)."""

    def __init__(self, dev):
        self.dev, self.times, self._undo = dev, {}, []

    def wrap(self, fn, name):
        def timed(*a, **kw):
            _sync(self.dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync(self.dev)
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return timed

    def patch(self, owner, attr, name):
        orig = getattr(owner, attr)
        setattr(owner, attr, self.wrap(orig, name))
        self._undo.append((owner, attr, orig))

    def undo(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)


def supervised_phase(cfg, ubm, seed: int, dev):
    """Phase 9: `trainer.train_supervised` at full width on SUP_UTTS x
    SUP_FRAMES frames drawn from the phase-3 UBM (realign_interval 0): a
    reference run of SUP_STEPS macro-steps, bitwise `trainer.train`; then
    one run with a NaN batch (step 1, attempt 0), host losses after steps
    1 (attempt 1) and 2 (attempt 2) and the step-2 checkpoint corrupted
    (attempt 2), which must end bitwise at the reference. Returns
    (record, launches by path)."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import manager as CM
    from repro_torch.core import guardrails as GR
    from repro_torch.core import trainer as TR
    from repro_torch.distributed import fault_tolerance as FT
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    feats = synthetic_corpus(ubm, SUP_UTTS, SUP_FRAMES, g)
    rec, paths = {"utterances": SUP_UTTS, "frames_per_utt": SUP_FRAMES,
                  "steps": SUP_STEPS}, {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sup_"))
    timed = _Timed(dev)
    try:
        timed.patch(TR, "iteration", "step")
        timed.patch(CM.CheckpointManager, "maybe_save", "save")
        timed.patch(CM.CheckpointManager, "restore_latest_verified",
                    "restore")

        def guardrail():
            hook = GR.make_guardrail(GR.GuardrailConfig(
                loglik_drop_tol=cfg.guardrail_loglik_drop))
            w = timed.wrap(hook, "check_state")
            w.reset = hook.reset
            return w

        def run(name, **kw):
            reset_counts()
            t0 = time.perf_counter()
            out = TR.train_supervised(
                cfg, ubm, feats, n_iters=SUP_STEPS,
                generator=torch.Generator().manual_seed(seed),
                ckpt_dir=tmp / name, guardrail=guardrail(), device=dev,
                **kw)
            _sync(dev)
            rec[f"{name}_s"] = time.perf_counter() - t0
            paths[f"supervised_{name}"] = read_counts()
            return out

        ref, rep = run("reference")
        if rep.n_restarts or rep.faults:
            fail(f"supervised reference run: {rep}")
        step_s = list(timed.times["step"])
        ckpt_dir = tmp / "reference" / f"step_{SUP_STEPS:08d}"
        rec["ckpt_bytes"] = sum(f.stat().st_size
                                for f in ckpt_dir.iterdir())
        plain = TR.train(cfg, ubm, feats, n_iters=SUP_STEPS,
                         generator=torch.Generator().manual_seed(seed),
                         device=dev)
        if not (torch.equal(ref.model.T, plain.model.T)
                and torch.equal(ref.model.Sigma, plain.model.Sigma)):
            fail("train_supervised is not bitwise trainer.train")
        del plain
        print(f"  reference: {SUP_STEPS} macro-steps in "
              f"{rec['reference_s']:.2f} s, bitwise trainer.train; "
              f"launches {paths['supervised_reference']}")
        chaos = FT.Chaos(
            poison_at=lambda s, a: (s, a) == (1, 0),
            fail_at=lambda s, a: (s, a) in ((2, 1), (3, 2)),
            corrupt_ckpt_at=lambda s, a: (s, a) == (2, 2))
        drill, rep = run("drill", chaos=chaos)
        if not (torch.equal(drill.model.T, ref.model.T)
                and torch.equal(drill.model.Sigma, ref.model.Sigma)):
            fail("the fault drill did not end bitwise at the reference")
        types = [f["type"] for f in rep.faults]
        if (rep.n_restarts != 3 or rep.rollbacks != 1
                or rep.skipped_corrupt != [2] or types != [
                    "GuardrailViolation", "InjectedFailure",
                    "InjectedFailure"]):
            fail(f"fault drill: {rep}")
        for name in ("reference", "drill"):
            require_launches(name, paths[f"supervised_{name}"],
                             ("gmm_rescore", "bw_stats", "tvm_estep_l_train",
                              "tvm_estep_a"))
        rec["faults"] = rep.faults
        rec["times"] = timed.times
        rec["step_s"] = step_s
        t = timed.times
        print(f"  drill: {rep.n_restarts} restarts, faults {types}, "
              f"rollbacks {rep.rollbacks}, skipped corrupt "
              f"{rep.skipped_corrupt}; bitwise the reference; "
              f"{rec['drill_s']:.2f} s; launches "
              f"{paths['supervised_drill']}")
        print("  recovery s: " + ", ".join(
            f"{f['type']} {f['recovery_s']:.3f}" for f in rep.faults))
        print(f"  macro-step s (reference) "
              f"{', '.join(f'{x:.3f}' for x in step_s)}; checkpoint "
              f"{rec['ckpt_bytes'] / 1e6:.1f} MB, save s "
              f"{np.median(t['save']):.3f} (median of {len(t['save'])}), "
              f"restore s {np.median(t['restore']):.3f} (median of "
              f"{len(t['restore'])}); check_state ms "
              f"{1e3 * np.median(t['check_state']):.2f} (median of "
              f"{len(t['check_state'])})")
    finally:
        timed.undo()
        shutil.rmtree(tmp, ignore_errors=True)
    return rec, paths


# ---------------------------------------------------------------------------
# Phase 10: the mesh of ranks (launch/mesh.py, the engine's mesh mode,
# launch/ivector_cell.py) at full width, several ranks on the one card
# ---------------------------------------------------------------------------

# 256 utterances x 512 frames drawn from the phase-3 UBM, normalised as in
# phase 7
MESH_UTTS, MESH_FRAMES = 256, 512
# the worlds of ranks spawned on the card over gloo, and their meshes
MESH_WORLDS = {2: ((2, 1), (1, 2)), 4: ((4, 1), (2, 2))}
MESH_TIMEOUT = 600
# model-sharded meshes against the one-rank run after 2 iterations: the
# tolerances of the JAX test_sharded_trajectory_fused_matches_dense_8dev
# (|a - b| <= atol + rtol |b| elementwise)
TT_TOL, SIG_TOL = (5e-3, 5e-3), (1e-3, 1e-4)
# exit_reduce 'psum' against 'ordered': the same partials summed in
# another order, within PSUM_TOL x max|value|
PSUM_TOL = 1e-5
# the sparse and fused rungs of sharded_align_stats against the dense one,
# with no posterior floor: each of n, f and S within RUNG_TOL x its
# max|value|, the limit phase 4 holds the rungs' i-vectors to. The JAX
# test_sharded_sparse_rescore_matches_dense holds them elementwise to
# rtol = atol = 1e-4 at D = 6 (tests/test_torch_mesh.py does the same
# against it); at D = 72 the rungs' logliks differ by up to ~1e-3 (f32
# cancellation in the 72-dim quadratic form: phase 3 reads 6e-4 between
# gmm_loglik and its plain version), and a posterior by twice that,
# relative. At the config's 0.025 floor a posterior that the rounding
# moves across the floor drops out and its frame's others renormalise,
# so per-utterance statistics there differ by up to ~1e-2 x max|value|
# (read on an H100 80GB HBM3, 700 W): printed, not held. The elementwise
# readings are printed beside.
RUNG_TOL = 1e-3
RUNG_ELEMENTWISE = (1e-4, 1e-4)
# train_ubm (1 diag + 1 full iteration) on a mesh against one rank: f32
# sums over 131,072 frames in another order, within UBM_TOL x max|value|
UBM_TOL = 1e-4
# kernels every rank of a mesh launches; the rescore-only gmm_align
# launch (gmm_rescore_fused) runs where the model axis is sharded
MESH_KERNELS = ("gmm_rescore", "bw_stats", "tvm_estep_l_train",
                "tvm_estep_a", "gmm_loglik")


def mesh_cfgs(cfg, n_utts: int):
    """The phase's configs: the ordered trajectories with one chunk a rank
    ((2, 1) with realignment and the full refresh, (4, 1) without), the
    model-sharded one (2 iterations, the chunk set per mesh), the
    macro-batch pair (macro-batches of n_utts / 4 over 2 ranks, chunks of
    half that) and the statistics pass (chunks of n_utts / 4)."""
    base = cfg.with_overrides(realign_interval=2, ubm_update="full",
                              update_sigma=True)
    return {"ordered_2": base.with_overrides(
                n_iters=3, estep_chunk=n_utts // 2),
            "ordered_4": base.with_overrides(
                n_iters=3, realign_interval=0, estep_chunk=n_utts // 4),
            "model": base.with_overrides(n_iters=2),
            "macro": base.with_overrides(n_iters=2,
                                         estep_chunk=n_utts // 8),
            "nf": base.with_overrides(estep_chunk=n_utts // 4)}


def digest(t) -> str:
    """sha256 of a tensor's f32 bytes (+0.0 makes -0.0 and 0.0 one)."""
    import hashlib
    return hashlib.sha256((t.detach().float() + 0.0).contiguous().cpu()
                          .numpy().tobytes()).hexdigest()


def peak_text(gbs) -> str:
    return ("not measured" if None in gbs
            else f"{max(gbs):.2f} GB")


def tt(T):
    return torch.einsum("cdr,cer->cde", T, T)


def close_reading(got, want, tol) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 passes."""
    rtol, atol = tol
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def mesh_kernel_checks(ubm, feats, cfg):
    """Each kernel of the mesh path against its plain version at a rank's
    shapes on the model-sharded meshes (C_loc = C / 2 = 1,024), on the
    limits of phase 3 (TOL): the rank-0 block of the rows, the slots that
    the two-stage top-K gives rank 0 (another rank's slots at local id 0,
    as ``engine._align_sharded`` passes them). Returns the errors and the
    kernel times."""
    from repro_torch.core import engine as EN
    from repro_torch.core import ubm as U
    from repro_torch.kernels import bw_stats as BW
    from repro_torch.kernels import gmm_align as GA
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import gmm_rescore as GR
    from repro_torch.kernels import ref
    from repro_torch.kernels import tvm_estep as TE
    C, D = ubm.means.shape
    Cl, K = C // 2, cfg.posterior_top_k
    pack = EN.pack_ubm(ubm, feats.device)
    const, lin, P = (t[:Cl].contiguous() for t in pack.pre)
    linT, Pf = lin.T.contiguous(), P.reshape(Cl, D * D).contiguous()
    x = feats.reshape(-1, D)[:16384].contiguous()
    _, sel = ref.diag_topk(x, *U.diag_coeffs(pack.diag), K)
    own = sel < Cl
    loc = torch.where(own, sel, torch.zeros_like(sel)).contiguous()
    out = {"own_share": own.float().mean().item()}
    A, A2 = pack.rescore_A[:Cl].contiguous(), pack.align_A[:Cl].contiguous()
    out["gmm_rescore"] = compare(
        f"gmm_rescore [{x.shape[0]}x{K}] of C_loc={Cl}",
        GR.gmm_rescore(x, loc, A), ref.gmm_rescore(x, loc, const, linT, Pf))
    out["gmm_rescore_ms"] = cuda_ms(lambda: GR.gmm_rescore(x, loc, A), 10)
    out["gmm_rescore_fused"] = compare(
        f"gmm_rescore_fused (gmm_align, rescore only) [{x.shape[0]}x{K}] of "
        f"C_loc={Cl}", GA.gmm_rescore_fused(x, loc, A2),
        ref.gmm_rescore_fused(x, loc, A2))
    out["gmm_rescore_fused_ms"] = cuda_ms(
        lambda: GA.gmm_rescore_fused(x, loc, A2), 10)
    xs = x[:4096].contiguous()
    out["gmm_loglik"] = compare(
        f"gmm_loglik [4096x{D}] x C_loc={Cl}",
        GL.gmm_loglik(xs, const, linT, Pf), ref.gmm_loglik(xs, const, linT,
                                                           Pf))
    out["gmm_loglik_ms"] = cuda_ms(
        lambda: GL.gmm_loglik(xs, const, linT, Pf), 10)
    # Γ of rank 0's owned slots, the alignment's posteriors over the
    # selected set, at a chunk's 32,768 frames
    xb = feats.reshape(-1, D)[:32768].contiguous()
    _, sb = ref.diag_topk(xb, *U.diag_coeffs(pack.diag), K)
    ll = ref.gmm_rescore(xb, sb, pack.pre[0], pack.pre[1].T.contiguous(),
                         pack.pre[2].reshape(C, D * D))
    post = torch.softmax(ll, dim=1) * (sb < Cl)
    gamma = torch.zeros((xb.shape[0], Cl), device=xb.device)
    gamma.scatter_add_(1, torch.where(sb < Cl, sb, 0), post)
    err = 0.0
    for name, a, w in zip(("n", "f", "S"), BW.bw_stats(gamma, xb),
                          ref.bw_stats(gamma, xb)):
        err = max(err, compare(f"bw_stats {name} [{xb.shape[0]}x{Cl}]ᵀ "
                               f"[{xb.shape[0]}x{D}]", a, w))
    out["bw_stats"] = err
    out["bw_stats_ms"] = cuda_ms(lambda: BW.bw_stats(gamma, xb), 5)
    # the E-step at a (2, 2) rank's chunk: 128 utterances x C_loc
    g = torch.Generator(device=xb.device).manual_seed(11)
    R = cfg.ivector_dim
    Pn = R * (R + 1) // 2
    n = torch.rand(MESH_UTTS // 2, Cl, generator=g, device=xb.device) * 30
    Up = torch.randn(Cl, Pn, generator=g, device=xb.device)
    PP = torch.randn(MESH_UTTS // 2, Pn, generator=g, device=xb.device)
    for name, run, plain, b in (("tvm_estep_l", TE.tvm_estep_l,
                                 ref.tvm_estep_l, Up),
                                ("tvm_estep_a", TE.tvm_estep_a,
                                 ref.tvm_estep_a, PP)):
        M, Kd = ((n.shape[0], Cl) if name == "tvm_estep_l"
                 else (Cl, n.shape[0]))
        form = TE.form(torch.float32, M, Kd, Pn)
        out[name] = compare(f"{name} {form} form, M={M} K={Kd} N={Pn}",
                            run(n, b), plain(n, b))
        out[f"{name}_ms"] = cuda_ms(lambda: run(n, b), 10)
    return out


def _comm_delta(mesh, before):
    return {k: [v[0] - before.get(k, [0, 0, 0.0])[0],
                v[1] - before.get(k, [0, 0, 0.0])[1],
                v[2] - before.get(k, [0, 0, 0.0])[2]]
            for k, v in mesh.comm.items()}


def mesh_rank(workdir: str, shapes, cfg, device=None):
    """One rank of phase 10 (spawned by ``launch.mesh.run_ranks``): each
    mesh of ``shapes`` on this world, every run counted from 0. Returns,
    by mesh, digests of what must be bitwise, the readings of what is held
    to a tolerance (rank 0 returns the arrays), launches, seconds, the
    collectives' bytes and seconds, and peak memory."""
    from repro_torch.core import engine as EN
    from repro_torch.core import trainer as TR
    from repro_torch.core import tvm as TV
    from repro_torch.core import ubm as U
    from repro_torch.launch import ivector_cell as IC
    from repro_torch.launch import mesh as MS
    inp = torch.load(Path(workdir) / "inputs.pt")
    feats, seed = inp["feats"], inp["seed"]
    n_utts = feats.shape[0]
    cfgs = mesh_cfgs(cfg, n_utts)
    out = {}
    for shape in shapes:
        mesh = MS.make_local_mesh(*shape, device=device)
        mesh.timing = True
        dev = mesh.device
        ubm = U.FullGMM(inp["w"].to(dev), inp["means"].to(dev),
                        inp["covs"].to(dev))
        C, D = ubm.means.shape
        d, m = mesh.data_extent, mesh.model_extent
        rec = {"rank": mesh.rank, "backend": mesh.backend,
               "device": str(dev), "launches": {}, "comm": {}, "by_op": {}}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

        def run(name, fn):
            before = {k: list(v) for k, v in mesh.comm.items()}
            before_op = {k: list(v) for k, v in mesh.by_op.items()}
            reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            res = fn()
            _sync(dev)
            rec[f"{name}_s"] = time.perf_counter() - t0
            rec[f"{name}_t0"] = t0
            rec["launches"][name] = read_counts()
            rec["comm"][name] = _comm_delta(mesh, before)
            rec["by_op"][name] = {
                k: [v[0] - before_op.get(k, [0, 0])[0],
                    v[1] - before_op.get(k, [0, 0])[1]]
                for k, v in mesh.by_op.items()
                if v != before_op.get(k, [0, 0])}
            return res

        gmm = run("train_ubm", lambda: U.train_ubm(
            feats.reshape(-1, D), C, torch.Generator().manual_seed(seed),
            diag_iters=1, full_iters=1, top_k=cfg.posterior_top_k,
            chunk=64, frame_chunk=feats.shape[1], mesh=mesh))
        rec["train_ubm_collectives"] = sum(
            v[0] for v in rec["comm"]["train_ubm"].values())
        if m == 1:
            tcfg = cfgs["ordered_2" if d == 2 else "ordered_4"]
        else:
            tcfg = cfgs["model"].with_overrides(estep_chunk=n_utts // d)
        ends = []
        st = run("train", lambda: TR.train(
            tcfg, ubm, feats, generator=torch.Generator().manual_seed(seed),
            callback=lambda s, dg: (_sync(dev), ends.append(
                time.perf_counter())), mesh=mesh))
        rec["iteration_s"] = [b - a for a, b in zip(
            [rec["train_t0"]] + ends[:-1], ends)]
        rec["digest"] = {"T": digest(st.model.T),
                         "Sigma": digest(st.model.Sigma),
                         "means": digest(st.ubm.means),
                         "ubm_means": digest(gmm.means),
                         "ubm_covs": digest(gmm.covs)}
        if mesh.rank == 0:
            rec["ubm"] = (gmm.means.cpu(), gmm.covs.cpu())
        if m == 1:
            iv = run("extract", lambda: TR.extract(tcfg, st, feats,
                                                   mesh=mesh))
            rec["digest"]["iv"] = digest(iv)
        elif mesh.rank == 0:
            rec["TT"], rec["Sigma"] = tt(st.model.T).cpu(), \
                st.model.Sigma.cpu()
        del st
        fl, _ = TR._place(mesh, feats, None)
        nf, _ = run("stats", lambda: TR.stats_ll(cfgs["nf"], ubm, fl,
                                                 mesh=mesh))
        rec["digest"]["n"], rec["digest"]["f"] = digest(nf.n), digest(nf.f)
        del nf
        model0 = TV.init_model(torch.Generator().manual_seed(seed),
                               ubm.means, ubm.covs, cfg.ivector_dim,
                               cfg.formulation, cfg.prior_offset)
        acc, S = run("macro_step", lambda: IC.em_macro_step(
            tcfg, mesh, ubm.weights, ubm.means, ubm.covs, model0.T,
            model0.Sigma, model0.prior, feats, utt_chunk=n_utts // d))
        if shape == (2, 1):
            # the same pass with the ordered exit, against the psum one
            spec = EN.EngineSpec(
                n_components=C, top_k=cfg.posterior_top_k,
                floor=cfg.posterior_floor, second_order="full",
                chunk=n_utts // d, rescore=cfg.rescore)
            accums = (EN.TotalsAccum(spec, D), EN.TVMAccum(
                model0, TV.precompute(model0, estep=cfg.estep, device=dev),
                estep_dtype=cfg.estep_dtype))
            (tot_o, acc_o), _ = EN.stream(spec, EN.pack_ubm(ubm, dev), fl,
                                          None, accums, mesh=mesh)
            pairs = list(zip(acc, acc_o)) + [(S, tot_o.ss)]
            rec["psum_reading"] = max(
                (a - b).abs().max().item() / b.abs().max().item()
                for a, b in pairs)
            # macro-batches of the rank's block through prefetch_to_device
            # against the resident pass with the same chunks
            gen = torch.Generator
            a = TR.train(cfgs["macro"], ubm, feats,
                         generator=gen().manual_seed(seed), mesh=mesh)
            b = run("macro_batch", lambda: TR.train(
                cfgs["macro"], ubm, feats, generator=gen().manual_seed(seed),
                mesh=mesh, macro_batch=n_utts // 4, prefetch=2))
            rec["macro_bitwise"] = (torch.equal(a.model.T, b.model.T) and
                                    torch.equal(a.model.Sigma, b.model.Sigma))
            del a, b, accums, acc_o, tot_o
        del acc, S, model0
        if m > 1:
            pre = U.full_precisions(ubm)
            rungs = ("fused",) if d == 1 else EN.RESCORE_LADDER
            for floor in ((0.0, cfg.posterior_floor) if d > 1 else (0.0,)):
                got = {}
                for r in rungs:
                    got[r] = run(f"align_{r}_{floor}",
                                 lambda: IC.sharded_align_stats(
                                     cfg.with_overrides(
                                         rescore=r, posterior_floor=floor),
                                     mesh, ubm.to_diag(), pre, feats,
                                     second_order=True))
                if "dense" in got:
                    pairs = [(a, w) for r in ("sparse", "fused")
                             for a, w in zip(got[r], got["dense"])]
                    rec[f"rung_reading_{floor}"] = max(
                        (a - w).abs().max().item() / w.abs().max().item()
                        for a, w in pairs)
                    rec[f"rung_elementwise_{floor}"] = max(
                        close_reading(a, w, RUNG_ELEMENTWISE)
                        for a, w in pairs)
                del got
            del pre
        rec["peak_mem_gb"] = (torch.cuda.max_memory_allocated(dev) / 1e9
                              if dev.type == "cuda" else None)
        out[shape] = rec
        del fl, ubm
        torch.cuda.empty_cache()
    return out


def mesh_phase(cfg, ubm, g, seed: int, dev, card: str):
    """Phase 10: the kernels at a rank's shapes, the one-rank references in
    this process (no process group), then the worlds of MESH_WORLDS
    spawned on the card over gloo, and the six checks. Returns (record,
    launches by path)."""
    import shutil
    import tempfile
    from repro_torch.core import trainer as TR
    from repro_torch.core import ubm as U
    from repro_torch.launch import mesh as MS
    C, D = ubm.means.shape
    feats = synthetic_corpus(ubm, MESH_UTTS, MESH_FRAMES, g)
    flat = feats.reshape(-1, D)
    feats = (feats - flat.mean(dim=0)) / flat.std(dim=0)
    rec = {"utterances": MESH_UTTS, "frames_per_utt": MESH_FRAMES,
           "card": card}
    print(f"  corpus: {MESH_UTTS} utterances x {MESH_FRAMES} frames, "
          "normalised; kernels at a model-sharded rank's shapes:")
    rec["kernels_c_loc"] = mesh_kernel_checks(ubm, feats, cfg)
    cfgs = mesh_cfgs(cfg, MESH_UTTS)
    gen = torch.Generator
    refs, at2 = {}, {}

    def keep2(state, diag):
        if state.iteration == 2:
            at2.update(TT=tt(state.model.T), Sigma=state.model.Sigma.clone())

    t0 = time.perf_counter()
    for name, cb in (("ordered_2", keep2), ("ordered_4", None)):
        st = TR.train(cfgs[name], ubm, feats, generator=gen().manual_seed(
            seed), callback=cb, device=dev)
        iv = TR.extract(cfgs[name], st, feats, device=dev)
        refs[name] = {"T": digest(st.model.T),
                      "Sigma": digest(st.model.Sigma),
                      "means": digest(st.ubm.means), "iv": digest(iv)}
        del st, iv
    nf, _ = TR.stats_ll(cfgs["nf"], ubm, feats)
    refs["nf"] = {"n": digest(nf.n), "f": digest(nf.f)}
    del nf
    # train_ubm on pseudo-utterances of one utterance's frames, so that
    # they divide over the data ranks: 64 a chunk (32,768 frames)
    ref_ubm = U.train_ubm(feats.reshape(-1, D), C, gen().manual_seed(seed),
                          diag_iters=1, full_iters=1,
                          top_k=cfg.posterior_top_k, chunk=64,
                          frame_chunk=MESH_FRAMES, device=dev)
    _sync(dev)
    rec["one_rank_s"] = time.perf_counter() - t0
    print(f"  one-rank references (no process group): "
          f"{rec['one_rank_s']:.1f} s")
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    # each rank takes its card as launch.mesh.default_device gives it
    # (cuda:0 for every rank on one card); a CPU rehearsal passes "cpu"
    rank_dev = None if dev.type == "cuda" else "cpu"
    paths, ranks = {}, {}
    try:
        torch.save({"feats": feats.cpu(), "w": ubm.weights.cpu(),
                    "means": ubm.means.cpu(), "covs": ubm.covs.cpu(),
                    "seed": seed}, workdir / "inputs.pt")
        for world, shapes in MESH_WORLDS.items():
            t0 = time.perf_counter()
            outs = MS.run_ranks(mesh_rank, world,
                                args=(str(workdir), shapes, cfg, rank_dev),
                                backend="gloo", device=dev,
                                timeout=MESH_TIMEOUT, workdir=workdir)
            rec[f"world{world}_s"] = time.perf_counter() - t0
            for shape in shapes:
                ranks[shape] = [o[shape] for o in outs]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    for shape, rs in ranks.items():
        label = f"({shape[0]}, {shape[1]})"
        r0 = rs[0]
        # every rank holds the same results
        for k, v in r0["digest"].items():
            if any(r["digest"][k] != v for r in rs):
                fail(f"mesh {label}: ranks disagree on {k}")
        if any(r["backend"] != "gloo" or r["device"] != str(rank_dev or
                                                             "cuda:0")
               for r in rs):
            fail(f"mesh {label}: a rank left gloo on its device: "
                 f"{[(r['backend'], r['device']) for r in rs]}")
        # 1. data-only meshes: bitwise the one-rank trajectory
        if shape[1] == 1:
            want = refs["ordered_2" if shape[0] == 2 else "ordered_4"]
            for k in ("T", "Sigma", "means", "iv"):
                if r0["digest"][k] != want[k]:
                    fail(f"mesh {label}: {k} is not bitwise the one-rank "
                         "run's")
            print(f"  {label}: T, Sigma, UBM means and i-vectors bitwise "
                  f"the one-rank run ({'realignment, ' if shape[0] == 2 else ''}"
                  "ubm_update='full', ordered exit)")
        # 2. model-sharded meshes: n/f bitwise, T T^T and Sigma close
        else:
            rd = (close_reading(r0["TT"], at2["TT"].cpu(), TT_TOL),
                  close_reading(r0["Sigma"], at2["Sigma"].cpu(), SIG_TOL))
            rec[f"reading_{shape}"] = rd
            print(f"  {label}: after 2 iterations T T^T reading {rd[0]:.3e}"
                  f", Sigma {rd[1]:.3e} (|a-b| / (atol + rtol|b|); 1 is the "
                  f"limit: T T^T {TT_TOL}, Sigma {SIG_TOL})")
            if max(rd) > 1:
                fail(f"mesh {label}: T T^T or Sigma off the one-rank run")
        for k in ("n", "f"):
            if r0["digest"][k] != refs["nf"][k]:
                fail(f"mesh {label}: per-utterance {k} is not bitwise the "
                     "one-rank pass's")
        # train_ubm ran on the mesh and agrees with one rank
        if r0["train_ubm_collectives"] == 0:
            fail(f"mesh {label}: train_ubm dropped the mesh")
        um = max((a - b.cpu()).abs().max().item() / b.abs().max().item()
                 for a, b in zip(r0["ubm"], (ref_ubm.means, ref_ubm.covs)))
        rec[f"train_ubm_reading_{shape}"] = um
        if um > UBM_TOL:
            fail(f"mesh {label}: train_ubm off the one-rank run ({um:.3e})")
        # 5. every kernel of the path on every rank
        need = MESH_KERNELS + (("gmm_rescore_fused",) if shape[1] > 1
                               else ())
        for r in rs:
            total = {k: sum(c[k] for c in r["launches"].values())
                     for k in need}
            require_launches(f"mesh {label} rank {r['rank']}", total, need)
            for run_name, c in r["launches"].items():
                paths[f"mesh_{shape[0]}x{shape[1]}_r{r['rank']}_{run_name}"] \
                    = c
        print(f"  {label}: per-utterance n/f bitwise the one-rank pass; "
              f"train_ubm through the mesh, reading {um:.3e}; every rank "
              f"launched {', '.join(need)}")
    # 3. the psum exit, 4. the rungs, 6. macro-batches through prefetch
    psum = max(r["psum_reading"] for r in ranks[(2, 1)])
    print(f"  (2, 1) exit_reduce='psum' against 'ordered': {psum:.3e} x "
          f"max|value| (tolerance {PSUM_TOL})")
    rec["psum_reading"] = psum
    if psum > PSUM_TOL:
        fail("the psum exit disagrees with the ordered one")
    for floor in (0.0, cfg.posterior_floor):
        rung = max(r[f"rung_reading_{floor}"] for r in ranks[(2, 2)])
        elem = max(r[f"rung_elementwise_{floor}"] for r in ranks[(2, 2)])
        rec[f"rung_reading_{floor}"] = rung
        rec[f"rung_elementwise_{floor}"] = elem
        held = floor == 0.0
        print(f"  (2, 2) sharded_align_stats sparse and fused against dense, "
              f"floor {floor}: {rung:.3e} x max|value| "
              f"({f'tolerance {RUNG_TOL}' if held else 'not held'}); "
              f"elementwise at rtol = atol = 1e-4: reading {elem:.3e} (not "
              "held)")
        if held and rung > RUNG_TOL:
            fail("the rungs of sharded_align_stats disagree")
    if not all(r["macro_bitwise"] for r in ranks[(2, 1)]):
        fail("train(macro_batch, prefetch=2) is not bitwise the resident "
             "pass")
    print(f"  (2, 1) train(macro_batch={MESH_UTTS // 4}, prefetch=2) bitwise "
          f"the resident pass with {MESH_UTTS // 8}-utterance chunks")
    for shape, rs in ranks.items():
        r0 = rs[0]
        comm = {n: {k: v for k, v in c.items()}
                for n, c in r0["comm"].items()}
        fmt = "; ".join(
            f"{n}: " + ", ".join(f"{k} {v[1] / 1e6:.1f} MB {v[2]:.3f} s"
                                 for k, v in sorted(c.items()))
            for n, c in comm.items() if c and n in ("train", "macro_step"))
        print(f"  ({shape[0]}, {shape[1]}) {r0['backend']}: iteration s "
              f"{', '.join(f'{x:.3f}' for x in r0['iteration_s'])}; "
              f"em_macro_step {r0['macro_step_s']:.3f} s; rank 0 "
              f"collectives {fmt}; peak memory a rank "
              f"{peak_text([r['peak_mem_gb'] for r in rs])} ({card})")
        rec[f"mesh_{shape[0]}x{shape[1]}"] = [
            {k: v for k, v in r.items() if k not in ("ubm", "TT", "Sigma")}
            for r in rs]
    return rec, paths


# ---------------------------------------------------------------------------
# Phase 11: analysis/ and the kernel registry on the card
# ---------------------------------------------------------------------------

# one trainer.iteration at SMOKE's width on OPCOST_UTTS x OPCOST_FRAMES
# frames, counted on the card and on the CPU: the same contractions, so
# the flops are equal; the bytes within OPCOST_BYTES_TOL of each other
# (each kernel region counts the registry's work on both; the ops whose
# decomposition depends on the device, one_hot's range check and a number
# written into a tensor, are gone from the path)
OPCOST_UTTS, OPCOST_FRAMES = 16, 64
OPCOST_BYTES_TOL = 1e-3
# the full-width iteration: phase 5's corpus
ROOFLINE_UTTS, ROOFLINE_FRAMES = 640, 512


def registry_configs(cfg):
    """(label, registry kernel, config) of every kernel row at the main
    paths' shapes (PERF.md §6), gmm_align's whole-row instance (K = 40),
    its rescore alone, the f32 attention and the two backward kernels at
    phase 13's training shapes."""
    C, D, K, R = (cfg.n_components, cfg.feat_dim, cfg.posterior_top_k,
                  cfg.ivector_dim)
    P = R * (R + 1) // 2
    out = [("gmm_loglik", "gmm_loglik", dict(F=4096, C=C, D=D)),
           ("gmm_rescore", "gmm_rescore", dict(F=16384, K=K, C=C, D=D))]
    for tag in ("float32", "bfloat16"):
        sfx = "" if tag == "float32" else "_bf16"
        out += [(f"tvm_estep_l{sfx}", "tvm_estep",
                 dict(M=16, K=C, N=P, dtype=tag)),
                (f"tvm_estep_l{sfx}_train", "tvm_estep",
                 dict(M=512, K=C, N=P, dtype=tag)),
                (f"tvm_estep_a{sfx}", "tvm_estep",
                 dict(M=C, K=512, N=P, dtype=tag))]
    out += [("bw_stats", "bw_stats", dict(F=32768, C=C, D=D)),
            ("gmm_align", "gmm_align", dict(F=16384, C=C, D=D, K=K)),
            ("gmm_align K=40", "gmm_align", dict(F=16384, C=C, D=D, K=40)),
            ("gmm_rescore_fused", "gmm_align",
             dict(F=16384, C=C, D=D, K=K, rescore_only=True)),
            ("flash_attention", "flash_attention",
             dict(B=4, S=2048, H=32, KVH=8, hd=128, dtype="bfloat16")),
            ("flash_attention f32", "flash_attention",
             dict(B=4, S=2048, H=32, KVH=8, hd=128, dtype="float32")),
            ("selective_scan", "selective_scan",
             dict(B=4, T=2048, di=8192, ds=16)),
            ("flash_attention_bwd StableLM", "flash_attention_bwd",
             dict(B=4, S=4096, H=32, KVH=32, hd=64, dtype="bfloat16")),
            ("flash_attention_bwd Jamba", "flash_attention_bwd",
             dict(B=1, S=4096, H=32, KVH=8, hd=128, dtype="bfloat16")),
            ("selective_scan_bwd", "selective_scan_bwd",
             dict(B=1, T=4096, di=8192, ds=16)),
            # the i-vector kernels' new forms (phase 16)
            ("gmm_loglik D=256", "gmm_loglik", dict(F=4096, C=C, D=256)),
            ("gmm_rescore D=256", "gmm_rescore",
             dict(F=1024, K=K, C=C, D=256)),
            ("gmm_rescore C=65536", "gmm_rescore",
             dict(F=8192, K=K, C=65536, D=D)),
            ("bw_stats D=256", "bw_stats", dict(F=8192, C=C, D=256)),
            ("gmm_align D=256", "gmm_align", dict(F=4096, C=C, D=256, K=K)),
            ("gmm_align spill", "gmm_align",
             dict(F=1024, C=8192, D=D, K=8192))]
    return out


def registry_on_card(cfg, rows):
    """The registry's shared memory at the main paths' shapes against the
    card's opt-in limit (read from the card, through torch where it has it
    and through the CUDA runtime), and against the CUDA side's geometry
    where it exports it; then each kernel row's time against its bound."""
    from repro_torch.kernels import bw_stats as BW
    from repro_torch.kernels import gmm_align as GA
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import gmm_rescore as GR
    from repro_torch.kernels import registry
    props = torch.cuda.get_device_properties(0)
    torch_optin = getattr(props, "shared_memory_per_block_optin", None)
    runtime_optin = GA.smem_optin(0)
    if torch_optin is not None and torch_optin != runtime_optin:
        fail(f"shared memory opt-in: torch says {torch_optin}, the CUDA "
             f"runtime {runtime_optin}")
    budget = runtime_optin
    print(f"  shared memory a block may opt in to: {budget} bytes (torch: "
          f"{torch_optin}, CUDA runtime: {runtime_optin})")
    recs = []
    for label, name, c in registry_configs(cfg):
        inst = registry.get(name).instance(c)
        if inst.smem_bytes > budget:
            fail(f"registry: {label} asks {inst.smem_bytes} bytes of shared "
                 f"memory a block, above the card's {budget}")
        cuda = None
        if name == "gmm_align":
            g = GA.kernel_geometry(c["C"], c["D"], c["K"],
                                   c.get("rescore_only", False))
            cuda = None if g is None else ((-(-c["F"] // g[0]),), g[2])
        elif name == "gmm_rescore":
            g = GR.kernel_geometry(c["F"], c["K"], c["C"], c["D"])
            cuda = None if g is None else ((g.max_items,), g.smem_bytes)
        elif name == "gmm_loglik":
            g = GL.kernel_geometry(c["D"])
            cuda = None if g is None else (
                (-(-c["C"] // GL.BN), -(-c["F"] // g[0].bm)), g[0].smem)
        elif name == "bw_stats":
            # the runs are the wrapper's splits, which the CUDA side takes
            g = BW.kernel_geometry(c["D"])
            cuda = None if g is None else (
                (g.cols // (BW.PN if g.pairs else BW.BN),
                 -(-c["C"] // g.tile), inst.grid[2]), g.smem)
        if name in ("gmm_align", "gmm_rescore", "gmm_loglik", "bw_stats") \
                and \
                cuda != (inst.grid, inst.smem_bytes):
            fail(f"registry: {label} grid {inst.grid}, {inst.smem_bytes} "
                 f"bytes; the CUDA side's geometry: {cuda}")
        rings = ", ".join(f"{r.kind} x{r.stages}" for r in inst.rings)
        print(f"  {label}: grid {inst.grid} x {inst.threads} threads, "
              f"{inst.smem_bytes} bytes of shared memory"
              f"{' (= the CUDA side geometry)' if cuda else ''}; "
              f"rings: {rings or 'none'}")
        recs.append(dict(label=label, kernel=name, grid=inst.grid,
                         threads=inst.threads, smem_bytes=inst.smem_bytes,
                         cuda_geometry=cuda is not None))
    for r in rows:
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}): "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of its bound")
    return budget, recs


def autotune_vs_measured(cfg, utts, seed: int, dev):
    """autotune_align's predicted time against the measured gmm_align at
    F = 16,384, C = 2048, D = 72: the streaming instance (K = 20), the
    whole-row one (K = 40) and the rescore alone (gmm_rescore_fused)."""
    from repro_torch.analysis import roofline
    from repro_torch.core import engine as EN
    from repro_torch.core import ubm as U
    from repro_torch.kernels import gmm_align as GA
    ubm, model, _ = synthetic_system(cfg, seed, dev)
    del model
    pack = EN.pack_ubm(ubm, dev)
    dconst, dlin, dquad = (t.contiguous() for t in U.diag_coeffs(pack.diag))
    A2 = pack.align_A
    x = torch.from_numpy(np.concatenate(utts)[:16384]).to(dev).contiguous()
    F, D = x.shape
    C = A2.shape[0]
    out = []
    for K, only in ((cfg.posterior_top_k, False), (40, False),
                    (cfg.posterior_top_k, True)):
        tune = roofline.autotune_align(C, K, D, frames=F, rescore_only=only)
        if only:
            sel = GA.gmm_align(x, dconst, dlin, dquad, A2,
                               cfg.posterior_top_k)[1]
            ms = cuda_ms(lambda: GA.gmm_rescore_fused(x, sel, A2), 20)
        else:
            ms = cuda_ms(lambda: GA.gmm_align(x, dconst, dlin, dquad, A2,
                                              K), 20)
        what = "rescore alone" if only else f"K={K}"
        cands = "; ".join(f"{i} {bf} frames {t * 1e3:.4f}"
                          for i, bf, t in tune.candidates)
        print(f"  autotune_align {what}: {tune.instance} instance, "
              f"{tune.block_f} frames a block: predicted "
              f"{tune.t_predicted * 1e3:.4f} ms, measured {ms:.4f} ms "
              f"(measured / predicted {ms / (tune.t_predicted * 1e3):.2f}); "
              f"admitted: {cands}")
        out.append(dict(K=K, rescore_only=only, instance=tune.instance,
                        block_f=tune.block_f,
                        predicted_ms=tune.t_predicted * 1e3, ms=ms,
                        candidates=[(i, bf, t * 1e3)
                                    for i, bf, t in tune.candidates]))
    return out


def op_differences(a, b) -> dict:
    """{op or region: (calls, bytes) of ``a`` less ``b``} where two
    ``op_cost.OpCounter``s differ."""
    out = {}
    for table in ("by_op", "kernels"):
        ta, tb = getattr(a, table), getattr(b, table)
        for k in sorted(set(ta) | set(tb)):
            ra, rb = ta.get(k, [0, 0.0, 0.0]), tb.get(k, [0, 0.0, 0.0])
            if ra[0] != rb[0] or ra[2] != rb[2]:
                out[k] = (ra[0] - rb[0], ra[2] - rb[2])
    return out


def op_cost_card_vs_cpu(seed: int, dev):
    """One trainer.iteration at SMOKE's width counted on the card and on
    the CPU (the module comment above OPCOST_UTTS)."""
    from repro_torch.analysis import op_cost
    from repro_torch.configs.ivector_tvm import SMOKE
    from repro_torch.core import trainer as TR
    cpu = torch.device("cpu")
    ubm, model, g = synthetic_system(SMOKE, seed, cpu)
    feats = synthetic_corpus(ubm, OPCOST_UTTS, OPCOST_FRAMES, g)
    counted = {}
    for d in (dev, cpu):
        args = (model.to(d), ubm.to(d), feats.to(d))
        with op_cost.OpCounter() as c:
            TR.iteration(SMOKE, *args)
        counted[d.type] = c
    card, host = counted["cuda"], counted["cpu"]
    rel = abs(card.bytes - host.bytes) / host.bytes
    print(f"  op_cost, trainer.iteration at SMOKE width ({OPCOST_UTTS} x "
          f"{OPCOST_FRAMES} frames): flops card {card.flops:.6e}, CPU "
          f"{host.flops:.6e}; bytes card {card.bytes:.6e}, CPU "
          f"{host.bytes:.6e} ({rel:.2e} apart, tolerance "
          f"{OPCOST_BYTES_TOL:g}); kernel regions "
          f"{ {k: v[0] for k, v in card.kernels.items()} }")
    differ = op_differences(card, host)
    print(f"  ops the card and the CPU count differently (card - CPU, "
          f"calls and bytes): {differ or 'none'}")
    if card.flops != host.flops:
        fail("op_cost: the card and the CPU count other flops")
    if card.kernels.keys() != host.kernels.keys():
        fail("op_cost: the card and the CPU count other kernel regions")
    if rel > OPCOST_BYTES_TOL:
        fail("op_cost: the card's and the CPU's bytes differ beyond the "
             "tolerance")
    return {"flops": card.flops, "bytes_card": card.bytes,
            "bytes_cpu": host.bytes, "bytes_rel": rel, "differ": differ}


def iteration_roofline(cfg, seed: int, dev):
    """One trainer.iteration at phase 5's full width, timed, then counted
    by op_cost: its RooflineReport row against ivector_cell.model_flops
    and the measured wall."""
    from repro_torch.analysis import op_cost, roofline
    from repro_torch.core import trainer as TR
    from repro_torch.launch import ivector_cell as IC
    ubm, model, g = synthetic_system(cfg, seed, dev)
    feats = synthetic_corpus(ubm, ROOFLINE_UTTS, ROOFLINE_FRAMES, g)
    TR.iteration(cfg, model, ubm, feats)            # warm
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        TR.iteration(cfg, model, ubm, feats)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    with op_cost.OpCounter() as c:
        TR.iteration(cfg, model, ubm, feats)
    rep = roofline.roofline_from_counts(
        c, arch=cfg.arch_id,
        shape=f"{ROOFLINE_UTTS}x{ROOFLINE_FRAMES} frames", mesh_desc="(1, 1)",
        chips=1, peak_memory=float(peak),
        model_flops=IC.model_flops(
            cfg.with_overrides(frames_per_utt=ROOFLINE_FRAMES),
            ROOFLINE_UTTS))
    row = rep.row()
    wall = min(walls)
    t_bound = max(row["t_compute_s"], row["t_memory_s"],
                  row["t_collective_s"])
    print(f"  iteration at {ROOFLINE_UTTS} x {ROOFLINE_FRAMES} frames "
          f"({cfg.rescore} rung): wall {', '.join(f'{w:.3f}' for w in walls)}"
          f" s; counted {row['flops_per_device']:.4e} flops, "
          f"{row['bytes_per_device']:.4e} bytes; t_compute "
          f"{row['t_compute_s'] * 1e3:.3f} ms, t_memory "
          f"{row['t_memory_s'] * 1e3:.3f} ms, dominant {row['dominant']}, "
          f"useful_flops_ratio {row['useful_flops_ratio']:.3f}, "
          f"roofline_fraction {row['roofline_fraction']:.3f}; the bound is "
          f"{100 * t_bound / wall:.1f}% of the wall")
    top = sorted(c.kernels.items(), key=lambda kv: -kv[1][1])
    print("    kernel regions (calls, flops, bytes): " + "; ".join(
        f"{k} {v[0]}, {v[1]:.3e}, {v[2]:.3e}" for k, v in top))
    aten = sorted(c.by_op.items(), key=lambda kv: -kv[1][2])[:8]
    print("    aten ops outside them, most bytes first (calls, flops, "
          "bytes): " + "; ".join(f"{k} {v[0]}, {v[1]:.3e}, {v[2]:.3e}"
                                 for k, v in aten))
    return dict(row, wall_s=walls, bound_share_of_wall=t_bound / wall,
                kernels={k: list(v) for k, v in c.kernels.items()},
                aten={k: list(v) for k, v in aten})


def analysis_phase(cfg, utts, rows, seed: int, dev):
    """Phase 11: the registry on the card, autotune_align against the
    measured kernel, op_cost card against CPU and a full-width iteration's
    roofline, then the port's check gate with its dispatch pass on the
    card, which must report no unsuppressed finding."""
    from repro_torch.analysis.check import run_all
    rec = {}
    budget, rec["registry"] = registry_on_card(cfg, rows)
    rec["autotune"] = autotune_vs_measured(cfg, utts, seed, dev)
    torch.cuda.empty_cache()
    rec["op_cost"] = op_cost_card_vs_cpu(seed, dev)
    rec["iteration"] = iteration_roofline(cfg, seed, dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report = run_all([str(ROOT / "src" / "repro_torch")], device=dev,
                     budget=budget)
    for f in report["findings"]:
        if not f.suppressed:
            print("  " + f.format())
    print(f"  check gate (dispatch pass on {dev}): {report['unsuppressed']} "
          f"unsuppressed finding(s), {report['suppressed']} suppressed, in "
          f"{time.perf_counter() - t0:.1f} s")
    if report["unsuppressed"]:
        fail("the port's check gate reports findings")
    rec["check"] = {"unsuppressed": report["unsuppressed"],
                    "suppressed": report["suppressed"],
                    "wall_s": report["wall_s"]}
    return rec


# ---------------------------------------------------------------------------
# Phase 12: lowering without a cluster (launch/dryrun.py, lower_cell)
# ---------------------------------------------------------------------------

# (b) em_macro_step on a one-rank mesh on the card at CONFIG, LOWER_UTTS x
# LOWER_FRAMES frames, against the same call lowered on meta tensors. The
# same aten ops and kernel regions run on both, each region counting the
# registry's work: outside the regions counted from a bound on their ids
# the flops are equal and the bytes within LOWER_BYTES_TOL; inside them
# the bound is at least what the card's ids touch
LOWER_UTTS, LOWER_FRAMES = 128, 1024
LOWER_BYTES_TOL = 1e-3


def dryrun_pins() -> dict:
    """The production rows' numbers tests/test_torch_dryrun.py pins on the
    CPU: its ``PINS`` literal, read without importing the test (which
    imports JAX)."""
    import ast
    tree = ast.parse((ROOT / "tests" / "test_torch_dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "PINS" for t in node.targets):
            return ast.literal_eval(node.value)
    fail("tests/test_torch_dryrun.py has no PINS")


def production_rows(card: str):
    """(a) ``ivector-tvm x train_4k`` lowered through ``launch.dryrun`` on
    16 x 16 and 2 x 16 x 16: each row printed and held, to the last digit,
    to the CPU's pins."""
    from repro_torch.launch import dryrun
    pins = dryrun_pins()
    hbm = torch.cuda.get_device_properties(0).total_memory
    rows = {}
    for multi in (False, True):
        tag = "multi" if multi else "single"
        _, row = dryrun.lower_cell("ivector-tvm", "train_4k", multi)
        if row["status"] != "ok":
            fail(f"lowering {tag}: {row}")
        coll = ", ".join(f"{k} {v:.6e}" for k, v in
                         sorted(row["collectives"].items()))
        print(f"  ivector-tvm x train_4k on {row['mesh']} (rank 0 of "
              f"{row['chips']}, meta): flops {row['flops_per_device']:.6e}, "
              f"bytes {row['bytes_per_device']:.6e}, collective bytes "
              f"{row['coll_bytes_per_device']:.6e} ({coll}); peak memory a "
              f"device (inputs + live) "
              f"{row['peak_memory_per_device'] / 1e9:.3f} GB of the "
              f"card's {hbm / 1e9:.1f} GB; t_compute "
              f"{row['t_compute_s'] * 1e3:.3f} ms, t_memory "
              f"{row['t_memory_s'] * 1e3:.3f} ms, t_collective "
              f"{row['t_collective_s'] * 1e3:.3f} ms, dominant "
              f"{row['dominant']}; useful_flops_ratio "
              f"{row['useful_flops_ratio']:.4f}, roofline_fraction "
              f"{row['roofline_fraction']:.4f}; lowered in "
              f"{row['lower_seconds']:.2f} s ({card})")
        off = {k: (row[k], v) for k, v in pins[tag].items() if row[k] != v}
        if off:
            fail(f"lowering {tag}: (row, CPU pin) differ: {off}")
        rows[tag] = row
    print("  both rows equal the CPU's pins to the last digit")
    return rows


def lowering_vs_card(cfg, seed: int, dev):
    """(b) em_macro_step on the card against the same call lowered on meta
    (the comment above LOWER_UTTS), and the lowering's peak beside the
    card's rise of allocated memory over the call."""
    from repro_torch.analysis import op_cost
    from repro_torch.core import tvm as TV
    from repro_torch.launch import ivector_cell as IC
    from repro_torch.launch import mesh as MS
    ubm, _, g = synthetic_system(cfg, seed, dev)
    feats = synthetic_corpus(ubm, LOWER_UTTS, LOWER_FRAMES, g)
    model0 = TV.init_model(g, ubm.means, ubm.covs, cfg.ivector_dim,
                           cfg.formulation, cfg.prior_offset)
    args = (ubm.weights, ubm.means, ubm.covs, model0.T, model0.Sigma,
            model0.prior, feats)
    mesh = MS.make_local_mesh(device=dev)

    def step():
        return IC.em_macro_step(cfg, mesh, *args, utt_chunk=LOWER_UTTS)
    step()                                     # warm
    _sync(dev)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step()
    _sync(dev)
    wall = time.perf_counter() - t0
    rise = torch.cuda.max_memory_allocated() - base
    check_finite("em_macro_step on the card", *out[0], out[1])
    del out
    with op_cost.OpCounter(mesh) as card:
        step()
    low = IC.lower_step(cfg.with_overrides(
        utts_per_batch=LOWER_UTTS, frames_per_utt=LOWER_FRAMES),
        MS.Mesh(MS.AXES, (1, 1), (0, 0), torch.device("meta")),
        utt_chunk=LOWER_UTTS)
    bound = sorted(low.id_bound)

    def outside(c):
        return (c.flops - sum(c.kernels[k][1] for k in bound),
                c.bytes - sum(c.kernels[k][2] for k in bound))
    (fc, bc), (fm, bm) = outside(card), outside(low)
    rel = abs(bm - bc) / bc
    print(f"  em_macro_step, {LOWER_UTTS} x {LOWER_FRAMES} frames, one rank "
          f"({cfg.rescore} rung): card {wall:.3f} s; outside the id-bound "
          f"regions {bound}: flops card {fc:.6e}, meta {fm:.6e}; bytes card "
          f"{bc:.6e}, meta {bm:.6e} ({rel:.2e} apart, tolerance "
          f"{LOWER_BYTES_TOL:g})")
    print(f"  ops counted differently (card - meta, calls and bytes): "
          f"{op_differences(card, low) or 'none'}")
    if fc != fm:
        fail("lowering: the card's and the lowered flops differ outside "
             "the id-bound regions")
    if rel > LOWER_BYTES_TOL:
        fail("lowering: the card's and the lowered bytes differ beyond the "
             "tolerance")
    gaps = {}
    for k in bound:
        (_, fk, bk), (_, fl, bl) = card.kernels[k], low.kernels[k]
        gaps[k] = {"flops": (fl, fk), "bytes": (bl, bk)}
        print(f"  id-bound region {k}: flops meta {fl:.6e} >= card "
              f"{fk:.6e} (gap {fl - fk:.3e}); bytes meta {bl:.6e} >= card "
              f"{bk:.6e} (gap {bl - bk:.3e})")
        if fl < fk or bl < bk:
            fail(f"lowering: the bound of {k} is below the card's count")
    ratio = low.peak_bytes / rise
    print(f"  peak of the step's own storages (the inputs, made before, "
          f"left out of both): lowered {low.peak_bytes / 1e9:.4f} GB, the "
          f"card's max_memory_allocated rise over the call "
          f"{rise / 1e9:.4f} GB (lowered / card {ratio:.3f})")
    return {"wall_s": wall, "flops_card": fc, "flops_meta": fm,
            "bytes_card": bc, "bytes_meta": bm, "bytes_rel": rel,
            "id_bound": gaps, "peak_meta": low.peak_bytes,
            "peak_rise_card": rise, "peak_ratio": ratio}


def lowering_vs_ranks(cfg, ranks):
    """(c) the (2, 2) mesh's em_macro_step lowered in a fake world of 4,
    rank by rank, against the collectives by op that phase 10's gloo ranks
    counted for the same call at the same shapes: equal."""
    from repro_torch.launch import ivector_cell as IC
    from repro_torch.launch import mesh as MS
    d = 2
    tcfg = mesh_cfgs(cfg, MESH_UTTS)["model"].with_overrides(
        estep_chunk=MESH_UTTS // d, utts_per_batch=MESH_UTTS,
        frames_per_utt=MESH_FRAMES)
    for r in ranks:
        with MS.fake_world(len(ranks), rank=r["rank"]):
            mesh = MS.make_local_mesh(2, 2)
            IC.lower_step(tcfg, mesh, utt_chunk=MESH_UTTS // d)
            got = {k: list(v) for k, v in mesh.by_op.items()}
        want = r["by_op"]["macro_step"]
        if got != want:
            fail(f"lowering (2, 2) rank {r['rank']}: fake world {got}, "
                 f"gloo {want}")
    print(f"  (2, 2) em_macro_step lowered in a fake world of 4: every "
          f"rank's collectives by op equal phase 10's gloo ranks' "
          f"({ranks[0]['by_op']['macro_step']}: [calls, bytes])")
    return ranks[0]["by_op"]["macro_step"]


def lowering_phase(cfg, seed: int, dev, card: str, ranks_2x2):
    """Phase 12: (a) the production rows, (b) the lowering against a run
    on the card, (c) against phase 10's gloo ranks."""
    rec = {"rows": production_rows(card)}
    rec["vs_card"] = lowering_vs_card(cfg, seed, dev)
    torch.cuda.empty_cache()
    rec["vs_ranks"] = lowering_vs_ranks(cfg, ranks_2x2)
    return rec


# ---------------------------------------------------------------------------
# Phase 13: LM training (launch/train.py, optim/, models.api, the backward
# kernels)
# ---------------------------------------------------------------------------

# the attention's gradients against autograd of the plain version on the
# same (exactly widened) inputs, max|diff| over max|plain| per gradient.
# f32: the same f32 products summed in another order (read on the CPU
# emulation: 1e-6). bf16: the kernel rounds each gradient once at its store
# (2^-8 of it) and forms Delta = rowsum(dO o) from the forward's bf16 o,
# itself rounded once: two roundings, 2^-7
ATT_BWD_F32_TOL = 1e-4
ATT_BWD_BF16_TOL = 2.0 ** -7
# the scan's gradients, max|diff| over max|plain|: 4096 f32 steps summed in
# another order, and the kernel's exp2 decays (ex2.approx, ~2^-22)
SCAN_BWD_TOL = 1e-4
# the first versions of the backward kernels (the attention backward on
# the CUDA cores, at hd 256 too, the scan backward walking all of T in one
# block): their times at these shapes (PERF.md §6; H100 80GB HBM3, 700 W),
# the yardstick the redesigned kernels are printed beside
FIRST_BWD_MS = {"flash_attention_bwd StableLM": 10.982,
               "flash_attention_bwd Jamba": 26.996,
               "flash_attention_bwd Gemma": 29.100,
               "selective_scan_bwd": 6.699}
# the f32 attention backward's times at these shapes (B = 1, S = 4096) on
# the CUDA-core kernels of the design before the register-blocked one
# (PERF.md §6; H100 80GB HBM3, 700 W)
F32_FIRST_BWD_MS = {"StableLM": 10.880, "Jamba": 27.108}
# segment lengths (chunks) the scan backward is swept over at Jamba's shape
SCAN_SEGMENTS = (4, 8, 16, 32, 64, 256)
# the hd-256 attention backward's query-head splits of the dK/dV pass
# (flash_attention.bwd_splits), swept at Gemma 2B's shape at these batches
ATT_BWD_SPLITS = (1, 2, 4, 8)
ATT_BWD_SPLIT_BATCHES = (1, 4)
# SMOKE train step, card against CPU from the same state and batch: the
# loss, grad norm and every moment leaf within SMOKE_TRAIN_TOL x max|value|
# (f32 sums in another order through the kernels, each within 1e-4 of its
# plain version); every param within the sign-flip bound: at step 1 an
# Adam step m^/(sqrt(v^) + eps) is ~sign(g), so an element whose gradient
# is ~0 on both may move by lr_1 either way (2 lr_1, times ADAM_R)
SMOKE_TRAIN_TOL = 1e-4
ADAM_R = 1.0004
# the full-width runs: TRAIN_4K's sequence, its batch of 256 cut to 4
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 4, 4096
H100_BF16_PEAK = 989e12


def _rel_errs(got, want, label, tol):
    """(max|diff|, max|diff| / max|plain|) over the gradients; fails when a
    gradient is past ``tol`` of its max|plain|."""
    err, rel = 0.0, 0.0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        e = (a.float() - w.float()).abs().max().item()
        r = e / w.float().abs().max().item()
        err, rel = max(err, e), max(rel, r)
        if r > tol:
            fail(f"{label} {name}: max|diff| / max|plain| {r:.3e} above "
                 f"{tol:g}")
    return err, rel


def check_attention_bwd_small(g, dev):
    """The backward at small shapes that the training shapes leave out:
    bf16 hd 192 (the width-256 instance: the backward's range 129 to 192)
    and the tensor-core kernels at
    ragged S under GQA and MQA (hd 256: ragged, GQA, and a short S of 80,
    its dK/dV pass split over the query heads, and a ragged GQA case of
    256 key-tile blocks, which takes no split) against their algorithm in
    f32 (``backward_blocks`` on the same bf16 o and lse, so the same
    Delta, and the same splits: what is left is the kernel's one rounding
    of each gradient at its store, 2^-8 of it, and the bf16 pairs'
    2^-16), each to ATT_BWD_BF16_TOL and bitwise repeatable. Their
    distance to autograd, which comes mostly from Delta's bf16 o at small
    S, is printed beside it."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    recs = []
    for B, S, H, KVH, hd in ((1, 100, 2, 1, 192), (2, 200, 4, 2, 64),
                             (1, 333, 4, 1, 128), (1, 333, 8, 1, 256),
                             (2, 200, 4, 2, 256), (1, 80, 8, 1, 256),
                             (4, 2000, 4, 2, 256)):
        q, k, v, do = (torch.randn(B, S, n, hd, generator=g, device=dev)
                       .to(torch.bfloat16) for n in (H, KVH, KVH, H))
        o, lse = FA.flash_attention(q, k, v, lse=True)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do)
        again = FA.flash_attention_bwd(q, k, v, o, lse, do)
        scope = FA.bwd_scope(torch.bfloat16, hd)
        splits = FA.bwd_splits(torch.bfloat16, B, S, H, KVH, hd)
        split = f", {splits} splits" if splits > 1 else ""
        label = (f"flash_attention_bwd B={B} S={S} H={H} KVH={KVH} hd={hd} "
                 f"bf16 ({scope}{split})")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{label}: not bitwise repeatable")
        ins = [t.float().requires_grad_() for t in (q, k, v)]
        plain = torch.autograd.grad(ref.flash_attention(*ins), ins,
                                    do.float())
        tol = ATT_BWD_BF16_TOL
        want = FA.backward_blocks(q.float(), k.float(), v.float(),
                                  o.float(), lse, do.float())
        err, rel = _rel_errs(got, want, label, tol)
        note = (f"against backward_blocks in f32; against autograd of "
                f"the plain version (not held) "
                f"{_rel_errs(got, plain, label, 1.0)[1]:.3e}")
        print(f"  {label}: max|diff| / max|plain| {rel:.3e} {note} "
              f"(tolerance {tol:g}), bitwise repeatable")
        recs.append(dict(case=label, max_abs_err=err, max_rel_err=rel,
                         tol=tol))
    return recs


def check_attention_bwd(g, dev):
    """flash_attention_bwd against autograd of ref.flash_attention on the
    card, bf16 and f32, at StableLM's (H = KVH = 32, hd 64) and Jamba's
    (H 32, KVH 8, hd 128) shapes, and bf16 at Gemma 2B's (H 8, KVH 1, hd
    256: the 64-row tensor-core kernels, the dK/dV pass split over the
    query heads; on inputs of a generator of its own), B = 1, S = 4096: a
    Jamba micro-batch's shape on the training path is the row. Times the
    kernel (beside its first version's, FIRST_BWD_MS), the plain backward
    (autograd of the plain forward, the graph kept), SDPA's backward, and
    the forward with and without the log-sum-exps; then the hd-256
    kernel's split sweep (check_attention_bwd_splits), the small cases
    of check_attention_bwd_small and the training rows' shapes
    (check_attention_bwd_training)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import registry
    sdpa = torch.nn.functional.scaled_dot_product_attention
    recs = []
    g_gemma = torch.Generator(device=dev).manual_seed(g.initial_seed() + 1)
    for label, B, S, H, KVH, hd, dtype, gen in (
            ("StableLM", 1, 4096, 32, 32, 64, torch.bfloat16, g),
            ("StableLM", 1, 4096, 32, 32, 64, torch.float32, g),
            ("Jamba", 1, 4096, 32, 8, 128, torch.bfloat16, g),
            ("Jamba", 1, 4096, 32, 8, 128, torch.float32, g),
            ("Gemma", 1, 4096, 8, 1, 256, torch.bfloat16, g_gemma)):
        tag = _dtype_name(dtype)
        q, k, v, do = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                       .to(dtype) for n in (H, KVH, KVH, H))
        o, lse = FA.flash_attention(q, k, v, lse=True)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do)
        again = FA.flash_attention_bwd(q, k, v, o, lse, do)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_bwd {label} {tag}: not bitwise repeatable")
        ins = [t.float().requires_grad_() for t in (q, k, v)]
        out = ref.flash_attention(*ins)
        dof = do.float()
        want = torch.autograd.grad(out, ins, dof, retain_graph=True)
        tol = ATT_BWD_F32_TOL if dtype == torch.float32 else ATT_BWD_BF16_TOL
        err, rel = _rel_errs(got, want, f"flash_attention_bwd {label} {tag}",
                             tol)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        cfg = dict(B=B, S=S, H=H, KVH=KVH, hd=hd, dtype=tag)
        b_ms, b_by = bound("flash_attention_bwd", **cfg)
        flops = registry.get("flash_attention_bwd").cost(cfg)[0]
        rec = dict(
            case=f"{label} B={B} S={S} H={H} KVH={KVH} hd={hd} {tag}",
            scope=FA.bwd_scope(dtype, hd),
            max_abs_err=err, max_rel_err=rel, tol=tol,
            ms=cuda_ms(lambda: FA.flash_attention_bwd(q, k, v, o, lse, do),
                       5),
            plain_ms=cuda_ms(lambda: torch.autograd.grad(
                out, ins, dof, retain_graph=True), 2),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True), 5),
            fwd_ms=cuda_ms(lambda: FA.flash_attention(q, k, v), 5),
            fwd_lse_ms=cuda_ms(lambda: FA.flash_attention(q, k, v, lse=True),
                               5))
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["bound_share"] = b_ms / rec["ms"]
        before = (FIRST_BWD_MS.get(f"flash_attention_bwd {label}")
                  if dtype == torch.bfloat16 else F32_FIRST_BWD_MS[label])
        which = ("first version" if dtype == torch.bfloat16
                 else "the CUDA cores' design before")
        was = (f" ({which}: {before:.3f} ms, "
               f"{before / rec['ms']:.2f}x)" if before else "")
        rec["before_ms"] = before
        print(f"  flash_attention_bwd {rec['case']} ({rec['scope']}): "
              f"max|diff| / max|plain| {rel:.3e} (tolerance {tol:g}), "
              f"bitwise repeatable; kernel {rec['ms']:.3f} ms{was}, "
              f"{rec['tflops']:.1f} TFLOP/s of the bound's "
              f"{flops / 1e9:.1f} GFLOP, {rec['bound_share']:.3f} of the "
              f"bound {b_ms:.4f} ms ({b_by}); plain {rec['plain_ms']:.3f} ms, "
              f"SDPA backward {rec['library_ms']:.3f} ms; forward "
              f"{rec['fwd_ms']:.4f} ms, with lse {rec['fwd_lse_ms']:.4f} ms")
        recs.append(rec)
        del q, k, v, do, o, lse, got, again, ins, out, want, qt, kt, vt, ot
        torch.cuda.empty_cache()
    recs[4]["split_sweep"] = check_attention_bwd_splits(g, dev, recs[4])
    recs += check_attention_bwd_small(g, dev)
    recs += check_attention_bwd_training(g, dev)
    r = recs[2]
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/csrc/flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention.py:80",
               **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")})
    return row, recs


def check_attention_bwd_training(g, dev):
    """The bf16 backward at the shapes of the training rows that the
    B = 1 cases above leave out: Moonlight (4 x 4096, MHA at hd 128),
    Whisper's decoder (4 x 448, a ragged S, 20 heads at hd 64) and
    InternVL2 (4 x 4096, a group of 7 at hd 64), each against autograd of
    the plain version to ATT_BWD_BF16_TOL and bitwise repeatable.
    Times the plain backward and SDPA's beside the kernel. Inputs from a
    generator of their own, seeded from ``g``'s seed."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(g.initial_seed() + 3)
    recs = []
    for model, B, S, H, KVH, hd in (("Moonlight", 4, 4096, 16, 16, 128),
                                    ("Whisper decoder", 4, 448, 20, 20, 64),
                                    ("InternVL2", 4, 4096, 14, 2, 64)):
        q, k, v, do = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                       .to(torch.bfloat16) for n in (H, KVH, KVH, H))
        o, lse = FA.flash_attention(q, k, v, lse=True)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do)
        again = FA.flash_attention_bwd(q, k, v, o, lse, do)
        label = (f"flash_attention_bwd {model} training B={B} S={S} H={H} "
                 f"KVH={KVH} hd={hd} bf16 "
                 f"({FA.bwd_scope(torch.bfloat16, hd)})")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{label}: not bitwise repeatable")
        ins = [t.float().requires_grad_() for t in (q, k, v)]
        out = ref.flash_attention(*ins)
        dof = do.float()
        plain = torch.autograd.grad(out, ins, dof, retain_graph=True)
        err, rel = _rel_errs(got, plain, label, ATT_BWD_BF16_TOL)
        del plain
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        ot = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        b_ms, b_by = bound("flash_attention_bwd", B=B, S=S, H=H, KVH=KVH,
                           hd=hd, dtype="bfloat16")
        rec = dict(
            case=label, max_abs_err=err, max_rel_err=rel,
            tol=ATT_BWD_BF16_TOL,
            ms=cuda_ms(lambda: FA.flash_attention_bwd(q, k, v, o, lse, do),
                       5),
            plain_ms=cuda_ms(lambda: torch.autograd.grad(
                out, ins, dof, retain_graph=True), 2),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                ot, (qt, kt, vt), dot, retain_graph=True), 5))
        print(f"  {label}: max|diff| / max|plain| {rel:.3e} against "
              f"autograd of the plain version (tolerance "
              f"{ATT_BWD_BF16_TOL:g}), bitwise repeatable; kernel "
              f"{rec['ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}); plain "
              f"{rec['plain_ms']:.3f} ms, SDPA backward "
              f"{rec['library_ms']:.3f} ms")
        recs.append(rec)
        del q, k, v, do, o, lse, got, again, ins, out, dof, qt, kt, vt, ot
        torch.cuda.empty_cache()
    return recs


def check_attention_bwd_splits(g, dev, gemma):
    """The hd-256 backward at Gemma 2B's shape (S = 4096, H 8, KVH 1) at
    each batch of ATT_BWD_SPLIT_BATCHES, at each split of the dK/dV pass
    in ATT_BWD_SPLITS (its blocks a key tile; 1 writes bf16 with no
    workspace): each split's gradients within ATT_BWD_BF16_TOL of
    autograd of the plain version and bitwise repeatable, timed, its share
    of the bound printed beside the default (``bwd_splits``: 1 at the
    training batch B = 4); ``gemma`` is the B = 1 row, timed at the
    default. Inputs from a generator of its own, seeded from ``g``'s
    seed."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(g.initial_seed() + 2)
    S, H, KVH, hd = 4096, 8, 1, 256
    sweep = {}
    for B in ATT_BWD_SPLIT_BATCHES:
        q, k, v, do = (torch.randn(B, S, n, hd, generator=gen, device=dev)
                       .to(torch.bfloat16) for n in (H, KVH, KVH, H))
        o, lse = FA.flash_attention(q, k, v, lse=True)
        ins = [t.float().requires_grad_() for t in (q, k, v)]
        plain = torch.autograd.grad(ref.flash_attention(*ins), ins,
                                    do.float())
        del ins
        default = FA.bwd_splits(torch.bfloat16, B, S, H, KVH, hd)
        b_ms, _ = bound("flash_attention_bwd", B=B, S=S, H=H, KVH=KVH, hd=hd,
                        dtype="bfloat16")
        row, rels = {}, {}
        for n in ATT_BWD_SPLITS:
            label = f"flash_attention_bwd Gemma B={B} splits={n}"
            got = FA.flash_attention_bwd(q, k, v, o, lse, do, _splits=n)
            again = FA.flash_attention_bwd(q, k, v, o, lse, do, _splits=n)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{label}: not bitwise repeatable")
            rels[n] = _rel_errs(got, plain, label, ATT_BWD_BF16_TOL)[1]
            row[n] = cuda_ms(lambda: FA.flash_attention_bwd(
                q, k, v, o, lse, do, _splits=n), 5)
            del got, again
        print(f"    Gemma B={B} S={S} hd={hd}: dK/dV splits -> ms, share of "
              f"bound {b_ms:.4f} ms, max|diff| / max|plain| against "
              f"autograd (tolerance {ATT_BWD_BF16_TOL:g}; each bitwise "
              f"repeatable): " + ", ".join(
                  f"{n}: {ms:.3f}, {b_ms / ms:.3f}, {rels[n]:.3e}"
                  for n, ms in row.items())
              + f"; the default {default}"
              + (f" (the row above: {gemma['ms']:.3f} ms)" if B == 1 else ""))
        sweep[B] = {"default": default, "ms": row, "max_rel_err": rels}
        del q, k, v, do, o, lse, plain
        torch.cuda.empty_cache()
    return sweep


def _scan_inputs(g, dev, B, T, di, ds, dt_shift):
    A = -torch.exp(0.5 * torch.randn(di, ds, generator=g, device=dev))
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, di, generator=g, device=dev) - dt_shift)
    dx = dt * torch.randn(B, T, di, generator=g, device=dev)
    Bc, Cc = (torch.randn(B, T, ds, generator=g, device=dev)
              for _ in range(2))
    return dt, dx, A, Bc, Cc


def check_scan_bwd_segments(g, dev):
    """The scan backward at ragged T with several segments, with h0 and
    dh_last (dh0 wanted), every d_state of BWD_D_STATES: each gradient
    within SCAN_BWD_TOL of autograd of the plain scan, bitwise
    repeatable."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as SS
    recs = []
    for B, T, di, ds in ((2, 1000, 200, 4), (1, 1000, 130, 8),
                         (2, 1000, 200, 16), (1, 700, 66, 32)):
        dt, dx, A, Bc, Cc = _scan_inputs(g, dev, B, T, di, ds, 2.0)
        h0, dh = (torch.randn(B, di, ds, generator=g, device=dev)
                  for _ in range(2))
        dy = torch.randn(B, T, di, generator=g, device=dev)
        _, _, hs = SS.selective_scan(dt, dx, A, Bc, Cc, h0, save_states=True)
        got = SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh,
                                    want_dh0=True)
        again = SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh,
                                      want_dh0=True)
        label = (f"selective_scan_bwd B={B} T={T} di={di} ds={ds}, "
                 f"{SS.n_segments(T)} segments, h0 and dh_last")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{label}: not bitwise repeatable")
        ins = [t.clone().requires_grad_() for t in (dt, dx, A, Bc, Cc, h0)]
        y, h_last = ref.selective_scan(*ins)
        want = torch.autograd.grad([y, h_last], ins, [dy, dh])
        rel = 0.0
        for name, a, w in zip(("d(dt)", "d(dx)", "dA", "dB", "dC", "dh0"),
                              got, want):
            r = (a - w).abs().max().item() / w.abs().max().item()
            rel = max(rel, r)
            if r > SCAN_BWD_TOL:
                fail(f"{label} {name}: max|diff| / max|plain| {r:.3e} "
                     f"above {SCAN_BWD_TOL:g}")
        print(f"  {label}: max|diff| / max|plain| {rel:.3e} (tolerance "
              f"{SCAN_BWD_TOL:g}), bitwise repeatable")
        recs.append(dict(case=label, max_rel_err=rel))
    return recs


def check_scan_bwd(g, dev):
    """selective_scan_bwd against autograd of ref.selective_scan at a Jamba
    micro-batch's shape (B = 1, T = 4096, di = 8192, ds = 16, no h0, as in
    training): every gradient within SCAN_BWD_TOL x max|plain|, and two
    runs bitwise equal; its time beside the first version's
    (FIRST_BWD_MS) and swept over the segment length (SCAN_SEGMENTS). No
    single PyTorch call computes it.
    Then the ragged cases of check_scan_bwd_segments."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import registry
    from repro_torch.kernels import selective_scan as SS
    B, T, di, ds = 1, 4096, 8192, 16
    dt, dx, A, Bc, Cc = _scan_inputs(g, dev, B, T, di, ds, 4.6)
    dy = torch.randn(B, T, di, generator=g, device=dev)
    _, _, hs = SS.selective_scan(dt, dx, A, Bc, Cc, save_states=True)
    got = SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy)
    again = SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy)
    if not all(torch.equal(a, b) for a, b in zip(got[:5], again[:5])):
        fail("selective_scan_bwd: not bitwise repeatable")
    ins = [t.clone().requires_grad_() for t in (dt, dx, A, Bc, Cc)]
    y, _ = ref.selective_scan(*ins)
    _sync(dev)
    t0 = time.perf_counter()
    want = torch.autograd.grad(y, ins, dy)
    _sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, rel = 0.0, 0.0
    for name, a, w in zip(("d(dt)", "d(dx)", "dA", "dB", "dC"), got, want):
        e = (a - w).abs().max().item()
        r = e / w.abs().max().item()
        err, rel = max(err, e), max(rel, r)
        if r > SCAN_BWD_TOL:
            fail(f"selective_scan_bwd {name}: max|diff| / max|plain| "
                 f"{r:.3e} above {SCAN_BWD_TOL:g}")
    cfg = dict(B=B, T=T, di=di, ds=ds)
    b_ms, b_by = bound("selective_scan_bwd", **cfg)
    nbytes = registry.get("selective_scan_bwd").cost(cfg)[1]

    def run():
        return SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy)
    row = dict(name="selective_scan_bwd", route="cuda",
               source="src/repro_torch/csrc/selective_scan.cu",
               replaces="src/repro/kernels/selective_scan.py:69",
               max_abs_err=err, max_rel_err=rel,
               ms=cuda_ms(run, 5),
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None,
               fwd_ms=cuda_ms(lambda: SS.selective_scan(dt, dx, A, Bc, Cc),
                              5),
               fwd_states_ms=cuda_ms(lambda: SS.selective_scan(
                   dt, dx, A, Bc, Cc, save_states=True), 5))
    before = FIRST_BWD_MS["selective_scan_bwd"]
    print(f"  selective_scan_bwd B={B} T={T} di={di} ds={ds} "
          f"({SS.n_segments(T)} segments of {SS.SEG_CHUNKS} chunks): "
          f"max|diff| / max|plain| {rel:.3e} (tolerance {SCAN_BWD_TOL:g}), "
          f"bitwise repeatable; kernel {row['ms']:.3f} ms (first version: "
          f"{before:.3f} ms, {before / row['ms']:.2f}x), "
          f"{nbytes / row['ms'] / 1e6:.1f} GB/s of the bound's "
          f"{nbytes / 1e6:.1f} MB, {b_ms / row['ms']:.3f} of the bound "
          f"{b_ms:.4f} ms ({b_by}); plain backward (one run, host clock) "
          f"{plain_ms:.1f} ms; forward {row['fwd_ms']:.4f} ms, saving the "
          f"chunk states {row['fwd_states_ms']:.4f} ms")
    sweep = {}
    keep = SS.SEG_CHUNKS
    try:
        for seg in SCAN_SEGMENTS:
            SS.SEG_CHUNKS = seg
            sweep[seg] = cuda_ms(run, 5)
    finally:
        SS.SEG_CHUNKS = keep
    print("    segment length (chunks: segments) -> ms, share of bound: "
          + ", ".join(f"{s} ({SS.n_segments(T, s)}): {ms:.3f}, "
                      f"{b_ms / ms:.3f}" for s, ms in sweep.items()))
    row["segment_sweep_ms"] = sweep
    row["bound_share"] = b_ms / row["ms"]
    del dt, dx, A, Bc, Cc, dy, hs, got, again, ins, y, want
    torch.cuda.empty_cache()
    row["small"] = check_scan_bwd_segments(g, dev)
    return row


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _leaves(state):
    """(name, tensor) of every leaf of a train state, params and moments."""
    out = [(f"params/{k}", v) for k, v in state["params"].items()]
    for w in ("m", "v"):
        out += [(f"{w}/{k}", v) for k, v in state["opt"][w].items()]
    return out + [("count", state["opt"]["count"])]


# the SMOKE train steps held card against CPU: (record key, arch,
# overrides). Jamba without and with its experts; RWKV-6's path launches
# no kernel (its WKV is matmuls, as in the reference)
SMOKE_TRAIN = (
    ("stablelm-1.6b", "stablelm-1.6b", {}),
    ("jamba-v0.1-52b", "jamba-v0.1-52b", {"moe": None}),
    ("jamba-v0.1-52b experts", "jamba-v0.1-52b", {}),
    ("moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b", {}),
    ("arctic-480b", "arctic-480b", {}),
    ("rwkv6-7b", "rwkv6-7b", {}),
    ("whisper-large-v3", "whisper-large-v3", {}),
    ("internvl2-1b", "internvl2-1b", {}),
)


def path_kernels(cfg) -> tuple:
    """The kernels a training step of ``cfg`` must launch."""
    if cfg.family == "ssm":
        return ()
    return ("flash_attention", "flash_attention_bwd") + (
        ("selective_scan", "selective_scan_bwd")
        if cfg.family == "hybrid" else ())


def train_batches(cfg, rows: int, seq: int, seed: int, dev):
    """next_batch() -> a train batch on ``dev``: ``rows`` x ``seq`` tokens
    and labels from the TokenPipeline, with frames (audio) or patches
    (vlm) [rows, n_frames, frontend_dim] in the activation dtype, drawn
    from a generator seeded with ``seed``."""
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.models import layers as L
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=rows,
        seed=seed))
    g = torch.Generator(device=dev).manual_seed(seed)
    media = {"audio": "frames", "vlm": "patches"}.get(cfg.family)

    def next_batch():
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.next().items()}
        if media:
            enc = cfg.encoder
            b[media] = torch.randn(rows, enc.n_frames, enc.frontend_dim,
                                   generator=g, device=dev).to(
                                       L.cfg_dtype(cfg))
        return b
    return next_batch


def smoke_train_vs_cpu(seed: int, dev, cases=SMOKE_TRAIN):
    """One make_train_step of each of ``cases`` (f32) on the card
    and on the CPU from the same state and batch (the MoE archs at their
    published capacity factor): the loss, grad norm and f32 moments within
    SMOKE_TRAIN_TOL (bf16 moments within one bf16 ulp, 2^-7, of their
    leaf's max), every param within the sign-flip bound."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    rec = {}
    for key, arch, over in cases:
        cfg = get_config(arch, smoke=True).with_overrides(**over)
        st_cpu = api.init_state(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
        st_dev = _tree_to(st_cpu, dev)
        b = train_batches(cfg, 4, 64, seed, "cpu")()
        step = api.make_train_step(cfg)
        reset_counts()
        s_dev, m_dev = step(st_dev, _tree_to(b, dev))
        launches = read_counts()
        require_launches(f"{key} SMOKE train step", launches,
                         path_kernels(cfg))
        s_cpu, m_cpu = step(st_cpu, b)
        worst = {}
        for k in ("loss", "grad_norm"):
            worst[k] = abs(float(m_dev[k]) - float(m_cpu[k])) / abs(
                float(m_cpu[k]))
        lr = float(m_cpu["lr"])
        p_err = 0.0
        mom = 0.0
        for (name, a), (_, w) in zip(_leaves(s_dev), _leaves(s_cpu)):
            a = a.cpu()
            if name == "count":
                if not torch.equal(a, w):
                    fail(f"{key} SMOKE: step counts differ")
                continue
            d = (a.float() - w.float()).abs().max().item()
            if name.startswith("params/"):
                p_err = max(p_err, d)
            else:
                mom = max(mom, d / max(w.abs().max().item(), 1e-30))
        worst["moments"] = mom
        p_bound = ADAM_R * 2 * lr + 1e-7
        # bf16 moments (Arctic's opt_state_dtype): an element whose f32
        # value lies at a rounding boundary may round one bf16 ulp apart
        mom_tol = (SMOKE_TRAIN_TOL if cfg.opt_state_dtype == "float32"
                   else 2 * BF16_HALF_ULP)
        ok = (worst["loss"] <= SMOKE_TRAIN_TOL
              and worst["grad_norm"] <= SMOKE_TRAIN_TOL
              and mom <= mom_tol and p_err <= p_bound)
        shown = ({k: v for k, v in launches.items() if v}
                 or "none (no kernel on this path)")
        print(f"  {key} SMOKE train step, card vs CPU: loss "
              f"{float(m_dev['loss']):.6f} vs {float(m_cpu['loss']):.6f}; "
              f"relative: loss {worst['loss']:.2e}, grad norm "
              f"{worst['grad_norm']:.2e} (tolerance {SMOKE_TRAIN_TOL:g}), "
              f"moments ({cfg.opt_state_dtype}, max over leaves) {mom:.2e} "
              f"(tolerance {mom_tol:g}); params max|diff| "
              f"{p_err:.2e} (bound 2 x {ADAM_R} x lr_1 = {p_bound:.2e}); "
              f"launches {shown}  "
              f"{'ok' if ok else 'DISAGREES'}")
        if not ok:
            fail(f"{key} SMOKE train step: card and CPU disagree")
        rec[key] = dict(worst, params_max_diff=p_err, params_bound=p_bound,
                        launches=launches)
    return rec


def train_flops(cfg, rows: int, seq: int):
    """(model flops of a training step of ``rows`` x ``seq`` positions,
    its reckoning): 6 N for each of the N active params in products
    (``n_active_params``: an MoE table counts top_k of its n_experts; not
    an untied embedding nor a positional table, which are lookups)
    a position, the encoder's params a frame for audio; plus attention,
    forward and backward: causal self-attention 6 B H hd S^2 a layer,
    Whisper's encoder 12 B H hd F^2 a layer and its cross-attention 12 B
    H hd S F a layer (non-causal: twice the causal count). RWKV-6's WKV
    chunks and the Mamba scans are not counted, nor remat's recompute."""
    from repro_torch.models import api
    from repro_torch.models import layers as L
    table = api.param_table(cfg, seq if cfg.family == "audio" else 0)
    # a tied embedding is also the head's product (Gemma)
    lookup = sum(int(np.prod(table[k][0])) for k in
                 ("embed", "pos_embed", "enc_pos_embed") if k in table
                 and not (k == "embed" and cfg.tie_embeddings))
    enc = sum(int(np.prod(v[0])) for k, v in table.items()
              if k.startswith("enc_layer/"))
    n = api.n_active_params(cfg, seq if cfg.family == "audio" else 0) \
        - lookup - enc
    hd = cfg.resolved_head_dim()
    bh = 6.0 * rows * cfg.n_heads * hd
    n_attn = {"hybrid": cfg.n_layers // max(cfg.attn_period, 1),
              "ssm": 0}.get(cfg.family, cfg.n_layers)
    attn = bh * seq * seq * n_attn
    dense = 6.0 * n * rows * seq
    text = (f"6 x {n:,} active params in products (of {api.n_params(cfg):,};"
            f" not the {lookup:,} of lookup tables) x {rows * seq:,} "
            f"positions = {dense:.4e} + causal attention 6 x B {rows} x H "
            f"{cfg.n_heads} x hd {hd} x S^2 {seq}^2 x {n_attn} layers = "
            f"{attn:.4e}")
    total = dense + attn
    if cfg.family == "audio":
        F, ne = cfg.encoder.n_frames, cfg.encoder.n_layers
        e_dense = 6.0 * enc * rows * F
        e_attn = 2 * bh * F * F * ne + 2 * bh * seq * F * cfg.n_layers
        total += e_dense + e_attn
        text += (f" + encoder 6 x {enc:,} params x {rows * F:,} frames = "
                 f"{e_dense:.4e} + encoder and cross attention 12 x B x H x "
                 f"hd x (F^2 {F}^2 x {ne} + S F {seq} x {F} x "
                 f"{cfg.n_layers}) = {e_attn:.4e}")
    if cfg.family == "ssm":
        text += " (the WKV's chunk products not counted)"
    return total, text


def state_digest(state) -> dict:
    """{leaf: a 64-bit checksum of its bits}: sum_i bits_i x w_i modulo
    2^64 over the leaf's elements as integers, w_i odd, so that any one
    element that differs changes the sum. Two states of this digest are
    compared instead of held together (two Moonlight train states do not
    fit beside a third)."""
    out = {}
    for name, t in _leaves(state):
        bits = t.detach().reshape(-1).view(
            {1: torch.int8, 2: torch.int16, 4: torch.int32,
             8: torch.int64}[t.element_size()])
        h = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, bits.numel(), 1 << 26):
            b = bits[i:i + (1 << 26)].to(torch.int64)
            w = torch.arange(i, i + b.numel(), device=t.device)
            h += (b * ((w * 2654435761) % (1 << 31) * 2 + 1)).sum()
        out[name] = int(h)
    return out


def lm_train_run(label, cfg, steps: int, seed: int, dev, repeat: bool,
                 rows: int = LM_TRAIN_BATCH, seq: int = LM_TRAIN_SEQ):
    """``steps`` make_train_step steps of ``rows`` x ``seq`` tokens
    (``train_batches``: with frames or patches where the family takes
    them), on random params from ``seed``; the launch counts set to 0
    before each step and read after it. With ``repeat``, one more step is
    taken twice from the same state and must give the same bits
    (``state_digest``). Then one more step under the profiler (device time
    by kernel; its launches uncounted). Returns a record with the launches
    summed over the ``steps`` steps."""
    from repro_torch.models import api
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    max_seq = seq if cfg.family == "audio" else 0
    state = api.init_state(cfg, torch.Generator(device=dev).manual_seed(seed),
                           max_seq=max_seq, device=dev)
    step = api.make_train_step(cfg)
    next_batch = train_batches(cfg, rows, seq, seed, dev)
    # positions a step: a vlm's patches and text
    pos = seq + (cfg.encoder.n_frames if cfg.family == "vlm" else 0)
    tokens = rows * pos
    secs, losses, norms, per_step = [], [], [], []
    total = {}
    for i in range(steps):
        batch = next_batch()
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        _sync(dev)
        secs.append(time.perf_counter() - t0)
        counts = read_counts()
        per_step.append({k: v for k, v in counts.items() if v})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if not (np.isfinite(losses[-1]) and np.isfinite(norms[-1])):
            fail(f"{label}: step {i + 1} loss or grad norm not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flops, reckoning = train_flops(cfg, rows, pos)
    warm = secs[1:] or secs
    s_step = sum(warm) / len(warm)
    rec = {"n_params": api.n_params(cfg, max_seq),
           "n_active_params": api.n_active_params(cfg, max_seq),
           "n_layers": cfg.n_layers, "batch": rows, "seq": seq,
           "positions": pos, "grad_accum": cfg.grad_accum,
           "step_s": secs, "s_per_step_warm": s_step,
           "tokens_per_s": tokens / s_step, "peak_mem_gb": peak_gb,
           "losses": losses, "grad_norms": norms,
           "launches_per_step": per_step, "launches": total,
           "model_flops": flops,
           "model_flops_share": flops / (s_step * H100_BF16_PEAK),
           "flops_reckoning": reckoning}
    what = (f"{rows} x {seq} tokens" if pos == seq
            else f"{rows} x ({pos - seq} patches + {seq} tokens)")
    if cfg.family == "audio":
        what += f" on {rows} x {cfg.encoder.n_frames} frames"
    print(f"  {label}: {rec['n_params'] / 1e9:.3f} B params "
          f"({rec['n_active_params'] / 1e9:.3f} B active); "
          f"{steps} steps of {what} "
          f"(grad_accum {cfg.grad_accum}): s a step {[f'{x:.3f}' for x in secs]}"
          f", steps 2..{steps} {s_step:.3f} s, {rec['tokens_per_s']:.0f} "
          f"tokens/s; peak device memory {peak_gb:.2f} GB; losses "
          f"{[f'{x:.4f}' for x in losses]}; grad norms "
          f"{[f'{x:.4f}' for x in norms]}")
    print(f"    launches a step: {per_step}")
    print(f"    model-flops share {rec['model_flops_share']:.4f} = "
          f"{flops:.4e} / ({s_step:.3f} s x 989e12); {reckoning}")
    if repeat:
        batch = next_batch()
        s_a, m_a = step(state, batch)
        d_a = state_digest(s_a)
        del s_a
        s_b, m_b = step(state, batch)
        same = (float(m_a["loss"]) == float(m_b["loss"])
                and d_a == state_digest(s_b))
        print(f"    step {steps + 1} taken twice from the same state: params "
              f"and moments {'bitwise equal' if same else 'DIFFER'} (every "
              f"leaf's 64-bit checksum)")
        if not same:
            fail(f"{label}: a step repeated from the same state differs")
        rec["repeat_bitwise"] = True
        del s_b
    rec["profile_step"] = profile_path(lambda: step(state, batch))
    print_profile(f"{label}: one step", rec["profile_step"], 8)
    del state
    torch.cuda.empty_cache()
    return rec


def supervised_lm_drill(seed: int, dev):
    """The port of tests/test_substrate.py's restart test on the card:
    StableLM SMOKE under run_supervised with a failure after step 4 ends
    bitwise at the uninterrupted 6-step run; then launch.train.main on the
    card (--smoke, with checkpoints). Returns (record, launches of the
    drill)."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.distributed.fault_tolerance import run_supervised
    from repro_torch.launch import train as LT
    from repro_torch.models import api
    cfg = get_config("stablelm-1.6b", smoke=True)
    pipe_cfg = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                   global_batch=4)
    step = api.make_train_step(cfg)

    def init():
        return api.init_state(
            cfg, torch.Generator(device=dev).manual_seed(seed + 7),
            device=dev)
    state = init()
    pipe = TokenPipeline(pipe_cfg)
    for _ in range(6):
        state, _ = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in pipe.next().items()})
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(d, save_interval=2, device=dev)
        reset_counts()
        rep = run_supervised(
            init_state_fn=init, train_step_fn=step,
            data_factory=lambda: TokenPipeline(pipe_cfg), n_steps=6,
            ckpt=ck, fail_at=lambda s, a: s == 4 and a == 0, device=dev)
        launches = read_counts()
        got, at, _ = ck.restore_latest(init())
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(state),
                                                           _leaves(got)))
    print(f"  supervised drill (StableLM SMOKE, failure after step 4): "
          f"{rep.n_restarts} restart, final step {rep.final_step}, restored "
          f"step {at}; params and moments "
          f"{'bitwise' if same else 'NOT'} equal to the uninterrupted run; "
          f"launches { {k: v for k, v in launches.items() if v} }")
    if not same or rep.n_restarts != 1 or at != 6:
        fail("supervised LM drill: the restarted run differs")
    with tempfile.TemporaryDirectory() as d:
        out = LT.main(["--arch", "stablelm-1.6b", "--smoke", "--steps", "4",
                       "--seq", "64", "--ckpt-dir", d, "--ckpt-interval",
                       "2", "--log-every", "2"])
    if out["final_step"] != 4 or not np.isfinite(out["losses"]).all():
        fail("launch.train.main on the card did not train")
    return {"restarts": rep.n_restarts, "bitwise": same,
            "launcher_losses": out["losses"]}, launches


# the full-width training runs after StableLM's: (record key, label, arch,
# overrides, steps, repeat, tokens a row). Jamba cut to one period
# (about 111 GB at full depth), Moonlight to 4 layers (about 337 GB at
# 48), RWKV-6 to 4 layers (its steps were the phase's longest: 7.4 s a
# step at 8 layers on an H100, five steps a run); RWKV-6's WKV is matmuls,
# as in the reference, so its path launches no kernel
LM_TRAIN = (
    ("jamba_train", "Jamba v0.1 without experts, one period (8 layers), "
     "bf16", "jamba-v0.1-52b", {"moe": None, "n_layers": 8}, 2, False,
     LM_TRAIN_SEQ),
    ("gemma_train", "Gemma 2B, CONFIG (18 layers, head dim 256: the bf16 "
     "backward on 64-row wgmma blocks), bf16, remat layer", "gemma-2b", {},
     2, False, LM_TRAIN_SEQ),
    ("moonlight_train", "Moonlight 16B-A3B cut to 4 layers (64 experts, top "
     "6, capacity factor 1.25), bf16, remat layer", "moonshot-v1-16b-a3b",
     {"n_layers": 4}, 2, True, LM_TRAIN_SEQ),
    ("rwkv_train", "RWKV-6 7B cut to 4 layers, bf16, remat layer (no kernel "
     "on this path)", "rwkv6-7b", {"n_layers": 4}, 2, True, LM_TRAIN_SEQ),
    ("whisper_train", "Whisper large-v3, CONFIG (32 + 32 layers), bf16, "
     "remat layer, through models.api.make_train_step", "whisper-large-v3",
     {}, 2, True, 448),
    ("internvl_train", "InternVL2-1B, CONFIG (24 layers), bf16, remat layer, "
     "through models.api.make_train_step", "internvl2-1b", {}, 2, True,
     LM_TRAIN_SEQ - 256),
)


def lm_training_phase(seed: int, dev):
    """Phase 13: both backward kernels against autograd of their plain
    versions, SMOKE train steps card vs CPU, StableLM-2 1.6B and the
    LM_TRAIN runs at full width, the supervised drill. Returns (kernel
    rows, launches by path, record)."""
    from repro_torch.configs import get_config
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    rec = {}
    t0 = time.perf_counter()
    fa_row, rec["attention_bwd"] = check_attention_bwd(g, dev)
    ss_row = check_scan_bwd(g, dev)
    rec["scan_bwd"] = ss_row
    rec["kernels_s"] = time.perf_counter() - t0
    rec["smoke_vs_cpu"] = smoke_train_vs_cpu(seed, dev)
    rec["stablelm_train"] = lm_train_run(
        "StableLM-2 1.6B, CONFIG, bf16, remat layer", get_config(
            "stablelm-1.6b"), 3, seed, dev, repeat=True)
    require_launches("stablelm_train", rec["stablelm_train"]["launches"],
                     path_kernels(get_config("stablelm-1.6b")))
    for key, label, arch, over, steps, repeat, seq in LM_TRAIN:
        cfg = get_config(arch).with_overrides(**over)
        rec[key] = lm_train_run(label, cfg, steps, seed, dev, repeat,
                                seq=seq)
        require_launches(key, rec[key]["launches"], path_kernels(cfg))
    print("  trained in bf16 (s a step, tokens/s, peak GB, model-flops "
          "share, launches of flash_attention_bwd):")
    for key in ("stablelm_train",) + tuple(k for k, *_ in LM_TRAIN):
        r = rec[key]
        print(f"    {key}: {r['s_per_step_warm']:.3f} s, "
              f"{r['tokens_per_s']:.0f} tokens/s, {r['peak_mem_gb']:.2f} GB, "
              f"{r['model_flops_share']:.4f}, "
              f"{r['launches'].get('flash_attention_bwd', 0)}")
    rec["supervised"], sup_launches = supervised_lm_drill(seed, dev)
    paths = {k: rec[k]["launches"]
             for k in ("stablelm_train",) + tuple(k for k, *_ in LM_TRAIN)}
    paths["supervised_lm"] = sup_launches
    return [fa_row, ss_row], paths, rec


# ---------------------------------------------------------------------------
# Phase 14: the LM side's mesh paths on the card (sharding rules on
# DTensor, ring attention, the expert-parallel MoE, elastic restore)
# ---------------------------------------------------------------------------

LM_MESH_TIMEOUT = 900
# tokens a step of the mesh runs: rows x positions (a vlm's patches
# included); the f32 pairs and Jamba's prefill at capacity factor 64 take
# fewer (their one-rank buffers are [E, T K 64 / E, d], and the mesh's
# exchanges move them through the host)
LM_MESH_ROWS, LM_MESH_SEQ = 4, 2048
LM_MESH_F32 = {"internvl_f32": (2, 512), "moonlight_f32": (2, 256)}
JAMBA_PREFILL = (2, 256)
# the f32 pairs against one rank: the loss and the grad norm to this share
# of themselves, every param to this absolute distance
# (tests/test_torch_mesh_lm.py's). One step from the warm-up's first rate
# (3e-6) moves a param by about that rate whatever its gradient, so the
# gradients themselves are held too: each leaf to LM_MESH_GRAD_RTOL of its
# largest one-rank entry (a gradient left a partial sum, or halved, is
# off by a large share of it)
LM_MESH_LOSS_RTOL, LM_MESH_PARAM_ATOL = 1e-4, 3e-3
LM_MESH_GRAD_RTOL = 1e-3
# every LM arch's SMOKE gradients (f32) on (2, 2), each rank against its
# own one-rank run: rows x positions
LM_MESH_ZOO = (4, 64)
# Jamba's prefill on the mesh against one rank (bf16 params, f32
# activations): the last position's logits, max |diff| / max |one rank|.
JAMBA_MESH_RTOL = 1e-3
# Jamba's prefill in its own bf16 activations. A product summed in another
# order moves some tokens' router scores enough to change their experts,
# and a token's new experts change the rest of its sequence, so the mesh
# is held at the first MoE layer: its output against one rank's
# moe_dense on the mesh's own input (max |diff| / max |one rank|), and,
# against the one-rank prefill, the share of tokens routed to the same
# experts and the output's error on those tokens.
JAMBA_BF16_A2A_RTOL = 3e-2
JAMBA_BF16_AGREE_MIN, JAMBA_BF16_AGREE_RTOL = 0.5, 0.1


def lm_mesh_cfgs():
    """The configs of phase 14, by name: full width, depth cut as listed
    (InternVL2's bf16 step at its full 24 layers). Moonlight's f32 pair
    weighs the router's aux loss by 0: on the mesh that loss is the mean
    of each rank's block's (the reference's ``pmean`` in ``moe_a2a``), on
    one rank it is the whole batch's, so the two steps differ in that
    term by design; tests/test_torch_mesh_lm.py holds the mesh's aux
    loss and its gradients against JAX. Four ranks share the
    card, and sharding does not shrink what they hold together: a bf16
    Moonlight step at 4 layers (35.4 GB of state, twice that while the
    new state is made, and the experts' gathers) ran out of the card's
    80 GB on an H100, so it runs at 2. StableLM-2's step, whose
    collectives are held against its lowering, runs 8 of its 24 layers
    for the phase's time (31 s a step at 24 on an H100)."""
    import dataclasses as dc
    from repro_torch.configs.base import get_config
    f32 = dict(param_dtype="float32", activation_dtype="float32")
    ivl = get_config("internvl2-1b")
    moon = get_config("moonshot-v1-16b-a3b")
    jamba = get_config("jamba-v0.1-52b")
    slm = get_config("stablelm-1.6b")
    return {
        "internvl_bf16": ivl,
        "internvl_f32": ivl.with_overrides(n_layers=2, **f32),
        "moonlight_bf16": moon.with_overrides(n_layers=2),
        "moonlight_f32": moon.with_overrides(
            n_layers=2, moe=dc.replace(moon.moe, capacity_factor=64.0,
                                       router_aux_loss=0.0), **f32),
        "jamba": jamba.with_overrides(
            n_layers=jamba.attn_period, activation_dtype="float32",
            moe=dc.replace(jamba.moe, capacity_factor=64.0)),
        "jamba_bf16": jamba.with_overrides(
            n_layers=jamba.attn_period,
            moe=dc.replace(jamba.moe, capacity_factor=64.0)),
        "stablelm_bf16": slm.with_overrides(n_layers=4),
        "stablelm_2l": slm.with_overrides(n_layers=2),
    }


def _mesh_shape(cfg, rows, seq, kind):
    from repro_torch.configs.base import ShapeConfig
    pos = seq + (cfg.encoder.n_frames if cfg.family == "vlm" else 0)
    return ShapeConfig(f"mesh_{kind}", pos, rows, kind)


def _text_seq(cfg, seq):
    """Text tokens of a step of ``seq`` positions (a vlm's patches come
    first)."""
    return seq - (cfg.encoder.n_frames if cfg.family == "vlm" else 0)


def lm_mesh_kernel_checks(dev):
    """The two kernels the phase's ranks launch under local_map, at a
    rank's block: Moonlight's attention on (2, 2) (half the batch, 8 of
    its 16 heads) forward against the plain version and backward against
    its f32 algorithm, and Jamba's scan on (2, 2) (half the channels)
    against the plain version."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as SS
    g = torch.Generator(device=dev).manual_seed(14)
    B, S, H, hd = LM_MESH_ROWS // 2, LM_MESH_SEQ, 8, 128
    q, k, v, do = (torch.randn(B, S, H, hd, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    label = f"flash_attention B={B} S={S} H={H} hd={hd} bf16 (a rank's block)"
    o, lse = FA.flash_attention(q, k, v, lse=True)
    err_f = compare_bf16(label, o, ref.flash_attention(q.float(), k.float(),
                                                       v.float()))
    got = FA.flash_attention_bwd(q, k, v, o, lse, do)
    want = FA.backward_blocks(q.float(), k.float(), v.float(), o.float(),
                              lse, do.float())
    err_b, rel_b = _rel_errs(got, want, "flash_attention_bwd (a rank's "
                             "block)", ATT_BWD_BF16_TOL)
    print(f"  flash_attention_bwd at the same block: max|diff| / max|plain| "
          f"{rel_b:.3e} against backward_blocks in f32 (tolerance "
          f"{ATT_BWD_BF16_TOL:g})")
    Bj, T = JAMBA_PREFILL
    di, ds = 2 * 4096 // 2, 16
    dt = torch.rand(Bj, T, di, generator=g, device=dev) * 0.1
    dx = torch.randn(Bj, T, di, generator=g, device=dev)
    A = -torch.rand(di, ds, generator=g, device=dev) - 0.5
    Bc, Cc = (torch.randn(Bj, T, ds, generator=g, device=dev)
              for _ in range(2))
    y, h = SS.selective_scan(dt, dx, A, Bc, Cc)
    yr, hr = ref.selective_scan(dt, dx, A, Bc, Cc)
    err_s = max(compare(f"selective_scan B={Bj} T={T} di={di} ds={ds} (a "
                        "rank's block)", y, yr),
                compare("  its h_last", h, hr))
    return {"flash_attention": err_f, "flash_attention_bwd": err_b,
            "selective_scan": err_s}


def _ref_dir(workdir: Path, name: str) -> Path:
    return workdir / f"ref_{name}"


def _leaf_file(d: Path, k: str, what: str = "") -> Path:
    return d / (what + k.replace("/", "__") + ".npy")


def _save_ref(workdir: Path, name: str, params, m, grads) -> None:
    """A one-rank result for the ranks to read: each param leaf after the
    step and each gradient leaf as an f32 .npy (memory-mapped there, so a
    rank reads its block only), the loss, the grad norm and each gradient
    leaf's largest |entry|."""
    d = _ref_dir(workdir, name)
    d.mkdir()
    for k, v in params.items():
        np.save(_leaf_file(d, k), v.detach().float().cpu().numpy())
    gmax = {}
    for k, v in grads.items():
        np.save(_leaf_file(d, k, "grad__"), v.float().cpu().numpy())
        gmax[k] = v.float().abs().max().item()
    (d / "grad_max.json").write_text(json.dumps(gmax))
    np.save(d / "loss.npy", np.float32(float(m["loss"])))
    np.save(d / "grad_norm.npy", np.float32(float(m["grad_norm"])))


@contextlib.contextmanager
def first_moe_call(store: dict):
    """Records in ``store`` the first MoE layer call of a Jamba forward
    inside the block: its params ``p``, input ``x`` and output ``y``."""
    from repro_torch.models import jamba as J
    inner = J.moe_ffn

    def wrapped(cfg, p, x, *args, **kw):
        y, aux = inner(cfg, p, x, *args, **kw)
        if not store:
            store.update(p=p, x=x, y=y)
        return y, aux

    J.moe_ffn = wrapped
    try:
        yield store
    finally:
        J.moe_ffn = inner


def lm_mesh_references(cfgs, workdir: Path, seed: int, dev):
    """The one-rank runs the ranks are held to, in this process (no
    process group): the f32 InternVL2 and Moonlight steps, Jamba's
    prefill. Returns their walls."""
    from repro_torch.models import api
    out = {}
    for name in ("internvl_f32", "moonlight_f32"):
        cfg = cfgs[name]
        rows, seq = LM_MESH_F32[name]
        t0 = time.perf_counter()
        state = api.init_state(cfg, torch.Generator(device=dev).manual_seed(
            seed), device=dev)
        batch = train_batches(cfg, rows, _text_seq(cfg, seq), seed, dev)()
        new, m = api.make_train_step(cfg)(state, batch)
        _sync(dev)
        out[name] = time.perf_counter() - t0
        new = new["params"]       # the new moments go before the grads
        _, grads = api.loss_and_grads(cfg, state["params"], batch)
        _save_ref(workdir, name, new, m, grads)
        del state, new, batch, grads
        torch.cuda.empty_cache()
    cfg = cfgs["jamba"]
    rows, seq = JAMBA_PREFILL
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    batch = train_batches(cfg, rows, seq, seed, dev)()
    _, logits = api.make_prefill_step(cfg)(params,
                                          {"tokens": batch["tokens"]})
    _sync(dev)
    out["jamba"] = time.perf_counter() - t0
    np.save(workdir / "ref_jamba_logits.npy", logits.float().cpu().numpy())
    del params, logits
    torch.cuda.empty_cache()
    print("  one-rank references (no process group): " + ", ".join(
        f"{k} {v:.1f} s" for k, v in out.items()))
    return out


def lowered_by_op(cfg, rows, seq, shape):
    """The collectives by op ([calls, bytes] a rank) of a train step of
    ``cfg`` lowered on meta tensors in a fake world on ``shape``."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MS
    n = int(np.prod(shape))
    with MS.fake_world(n):
        mesh = MS.make_local_mesh(*shape)
        DR.lower_lm(cfg, _mesh_shape(cfg, rows, seq, "train"), mesh)
    return {k: list(v) for k, v in mesh.by_op.items()}


def lm_mesh_rank(workdir: str, world: int, seed: int):
    """One rank of phase 14 (spawned by ``launch.mesh.run_ranks`` on the
    card over gloo). World 4: every arch's SMOKE gradients on (2, 2),
    InternVL2 on (1, 4) (the ring), Moonlight and StableLM-2 steps and
    Jamba's prefills on (2, 2) (the MoE exchange, the scan under
    local_map), the elastic save on (4, 1) and restore on
    (2, 2); world 2: a StableLM-2 step on (1, 2) and the restore onto
    (2, 1). Every main-path run counted from 0; returns walls, this
    rank's peak, bytes by op, launches and the comparisons' readings."""
    import dataclasses as dc
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.analysis.op_cost import OpCounter
    from repro_torch.checkpoint import manager as CM
    from repro_torch.launch import mesh as MS
    from repro_torch.models import api
    from repro_torch.sharding import make_rules, use_rules
    wd = Path(workdir)
    cfgs = lm_mesh_cfgs()
    rec = {"launches": {}, "walls": {}, "by_op": {}, "peaks": {}}

    def state_of(cfg, rules, params_only=False):
        gen = torch.Generator(device=rules.mesh.device).manual_seed(seed)
        with use_rules(rules):
            if params_only:
                return api.init_params(cfg, gen, device=rules.mesh.device)
            return api.init_state(cfg, gen, device=rules.mesh.device)

    def batch_of(cfg, rules, rows, seq, kind):
        b = train_batches(cfg, rows, _text_seq(cfg, seq), seed,
                          rules.mesh.device)()
        if kind == "prefill":
            b = {"tokens": b["tokens"]}
        with use_rules(rules):
            return api.distribute(b, api.input_axes(
                cfg, _mesh_shape(cfg, rows, seq, kind)))

    def run(name, rules, fn):
        mesh, dev = rules.mesh, rules.mesh.device
        before = {k: list(v) for k, v in mesh.by_op.items()}
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        with use_rules(rules), OpCounter(mesh):
            res = fn()
        _sync(dev)
        rec["walls"][name] = time.perf_counter() - t0
        rec["launches"][name] = read_counts()
        rec["peaks"][name] = torch.cuda.max_memory_allocated(dev) / 1e9
        rec["by_op"][name] = {
            k: [v[0] - before.get(k, [0, 0])[0],
                v[1] - before.get(k, [0, 0])[1]]
            for k, v in mesh.by_op.items() if v != before.get(k, [0, 0])}
        return res

    def step_run(name, cfg, shape, rows, seq):
        rules = make_rules(MS.make_local_mesh(*shape), cfg,
                           _mesh_shape(cfg, rows, seq, "train"))
        state = state_of(cfg, rules)
        batch = batch_of(cfg, rules, rows, seq, "train")
        step = api.make_train_step(cfg)
        new, m = run(name, rules, lambda: step(state, batch))
        rec[f"{name}_loss"] = float(m["loss"])
        del state, batch
        return rules, new, m

    def block_err(t, path):
        """max |this rank's block of DTensor t - its block of the .npy|."""
        ref_ = np.load(path, mmap_mode="r")
        loc = t.to_local()
        _, off = compute_local_shape_and_global_offset(
            t.shape, t.device_mesh, t.placements)
        blk = ref_[tuple(slice(o, o + n) for o, n in zip(off, loc.shape))]
        return (loc.float() - torch.as_tensor(
            np.ascontiguousarray(blk), device=loc.device)).abs().max().item()

    def held(name, cfg, rules, new, m, rows, seq):
        """max |param - one rank's| over this rank's blocks; the loss's and
        the grad norm's shares of the one-rank ones; and, from the same
        params and batch, each gradient leaf's max |diff| over this rank's
        block as a share of the one-rank leaf's largest entry."""
        d = _ref_dir(wd, name)
        for key in ("loss", "grad_norm"):
            want = float(np.load(d / f"{key}.npy"))
            rec[f"{name}_{key}_rel"] = abs(float(m[key]) - want) / abs(want)
        rec[f"{name}_param_err"] = max(
            block_err(t, _leaf_file(d, k)) for k, t in new["params"].items())
        params = state_of(cfg, rules, params_only=True)
        batch = batch_of(cfg, rules, rows, seq, "train")
        with use_rules(rules), api.on_mesh(params):
            _, grads = api.loss_and_grads(cfg, params, batch)
        gmax = json.loads((d / "grad_max.json").read_text())
        rec[f"{name}_grad_rel"] = max(
            block_err(g.redistribute(params[k].device_mesh,
                                     params[k].placements),
                      _leaf_file(d, k, "grad__")) / gmax[k]
            for k, g in grads.items())
        del params, batch, grads

    def free():
        torch.cuda.empty_cache()

    def zoo_grads():
        """Each LM arch's SMOKE loss gradients (f32; experts at capacity
        factor 64 and the router's aux loss weighed 0, as in Moonlight's
        pair, where the mesh's per-rank capacity and aux differ from one
        rank's by design) on (2, 2) against this rank's
        own one-rank run from the same params and batch: per arch, the
        largest max |diff| / max |one rank| over the leaves. Two split
        mesh axes are where torch 2.11's DTensor backward went wrong."""
        from repro_torch.configs.base import PORTED_ARCH_IDS, get_config
        rows, seq = LM_MESH_ZOO
        out = {}
        for arch in PORTED_ARCH_IDS:
            cfg = get_config(arch, smoke=True).with_overrides(
                param_dtype="float32", activation_dtype="float32")
            if cfg.moe is not None:
                cfg = cfg.with_overrides(moe=dc.replace(
                    cfg.moe, capacity_factor=64.0, router_aux_loss=0.0))
            rules = make_rules(MS.make_local_mesh(2, 2), cfg,
                               _mesh_shape(cfg, rows, seq, "train"))
            dev = rules.mesh.device
            params = api.init_params(cfg, torch.Generator(
                device=dev).manual_seed(seed), device=dev)
            b = train_batches(cfg, rows, _text_seq(cfg, seq), seed, dev)()
            _, want = api.loss_and_grads(cfg, params, b)
            try:
                with use_rules(rules):
                    dp = api.distribute(params, api.params_axes(cfg))
                    db = api.distribute(b, api.input_axes(
                        cfg, _mesh_shape(cfg, rows, seq, "train")))
                    with api.on_mesh(dp):
                        _, got = api.loss_and_grads(cfg, dp, db)
                out[arch] = max(
                    (got[k].full_tensor() - w).abs().max().item()
                    / max(w.abs().max().item(), 1e-30)
                    for k, w in want.items())
            except Exception as e:   # every arch reported, then failed
                out[arch] = f"{type(e).__name__}: {e}"[:300]
        return out

    if world == 4:
        t0 = time.perf_counter()
        rec["zoo_grad_rel"] = zoo_grads()
        rec["walls"]["zoo_grads"] = time.perf_counter() - t0
        free()
        # InternVL2-1B on (1, 4): 14 heads do not divide 4, so the ring
        r, new, m = step_run("internvl_bf16", cfgs["internvl_bf16"], (1, 4),
                             LM_MESH_ROWS, LM_MESH_SEQ)
        del new
        free()
        r, new, m = step_run("internvl_f32", cfgs["internvl_f32"], (1, 4),
                             *LM_MESH_F32["internvl_f32"])
        held("internvl_f32", cfgs["internvl_f32"], r, new, m,
             *LM_MESH_F32["internvl_f32"])
        del new
        free()
        # Moonlight on (2, 2) through moe_a2a
        r, new, m = step_run("moonlight_bf16", cfgs["moonlight_bf16"],
                             (2, 2), LM_MESH_ROWS, LM_MESH_SEQ)
        del new
        free()
        r, new, m = step_run("moonlight_f32", cfgs["moonlight_f32"], (2, 2),
                             *LM_MESH_F32["moonlight_f32"])
        held("moonlight_f32", cfgs["moonlight_f32"], r, new, m,
             *LM_MESH_F32["moonlight_f32"])
        del new
        free()
        # Jamba with experts, one period, prefill on (2, 2)
        cfg = cfgs["jamba"]
        rows, seq = JAMBA_PREFILL
        rules = make_rules(MS.make_local_mesh(2, 2), cfg,
                           _mesh_shape(cfg, rows, seq, "prefill"))
        params = state_of(cfg, rules, params_only=True)
        batch = batch_of(cfg, rules, rows, seq, "prefill")
        step = api.make_prefill_step(cfg)
        _, logits = run("jamba", rules, lambda: step(params, batch))
        want = np.load(wd / "ref_jamba_logits.npy")
        got = logits.full_tensor().float().cpu().numpy()
        rec["jamba_rel"] = float(np.abs(got - want).max()
                                      / np.abs(want).max())
        del params, batch, logits
        free()
        # the same in Jamba's own bf16 activations: the first MoE layer's
        # input and output and the logits, whole, for the parent to hold
        cfg = cfgs["jamba_bf16"]
        params = state_of(cfg, rules, params_only=True)
        batch = batch_of(cfg, rules, rows, seq, "prefill")
        step = api.make_prefill_step(cfg)
        with first_moe_call({}) as cap:
            _, logits = run("jamba_bf16", rules, lambda: step(params, batch))
        whole = {k: cap[k].full_tensor().cpu() for k in ("x", "y")}
        whole["logits"] = logits.full_tensor().cpu()
        if torch.distributed.get_rank() == 0:
            torch.save(whole, wd / "mesh_jamba_bf16.pt")
        del params, batch, logits, cap, whole
        free()
        # StableLM-2 1.6B on (2, 2): its collectives by op
        step_run("stablelm_bf16", cfgs["stablelm_bf16"], (2, 2),
                 LM_MESH_ROWS, LM_MESH_SEQ)
        free()
        # elastic: saved on (4, 1), restored on (2, 2)
        cfg = cfgs["stablelm_2l"]
        r41 = make_rules(MS.make_local_mesh(4, 1), cfg)
        params = state_of(cfg, r41, params_only=True)
        axes = api.params_axes(cfg)
        t0 = time.perf_counter()
        CM.CheckpointManager(wd / "elastic", logical_axes={"params": axes},
                             mesh=r41.mesh).maybe_save(1, {"params": params},
                                                       force=True)
        rec["walls"]["elastic_save"] = time.perf_counter() - t0
        del params
    targets = {4: ((2, 2),), 2: ((2, 1),)}[world]
    if world == 2:
        step_run("stablelm_2l_1x2", cfgs["stablelm_2l"], (1, 2),
                 LM_MESH_ROWS, LM_MESH_SEQ)
        free()
    cfg = cfgs["stablelm_2l"]
    axes = api.params_axes(cfg)
    whole = api.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), device="cuda")
    for shape in targets:
        rules = make_rules(MS.make_local_mesh(*shape), cfg)
        t0 = time.perf_counter()
        got, _, _ = CM.restore(wd / "elastic", {"params": dict.fromkeys(
            axes)}, step=1, rules=rules)
        key = "elastic_" + "x".join(map(str, shape))
        rec["walls"][key] = time.perf_counter() - t0
        same = True
        for k, t in got["params"].items():
            _, off = compute_local_shape_and_global_offset(
                t.shape, t.device_mesh, t.placements)
            loc = t.to_local()
            same &= torch.equal(loc, whole[k][tuple(
                slice(o, o + n) for o, n in zip(off, loc.shape))])
        rec[key + "_bitwise"] = bool(same)
        del got
    del whole
    free()
    return rec


def lm_mesh_phase(seed: int, dev, card: str):
    """Phase 14: the LM mesh on the card. The kernels at a rank's blocks,
    the one-rank references and the fake-world lowerings here, then
    worlds of 4 and 2 ranks on the card over gloo, and the checks.
    Returns (record, launches by path)."""
    import shutil
    import tempfile
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MS
    cfgs = lm_mesh_cfgs()
    rec = {"card": card}
    rec["kernels"] = lm_mesh_kernel_checks(dev)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_"))
    try:
        rec["one_rank_s"] = lm_mesh_references(cfgs, workdir, seed, dev)
        t0 = time.perf_counter()
        lowered = {
            "stablelm_bf16": lowered_by_op(cfgs["stablelm_bf16"],
                                           LM_MESH_ROWS, LM_MESH_SEQ,
                                           (2, 2)),
            "stablelm_2l_1x2": lowered_by_op(cfgs["stablelm_2l"],
                                             LM_MESH_ROWS, LM_MESH_SEQ,
                                             (1, 2))}
        rec["lowered_s"] = time.perf_counter() - t0
        ranks = {}
        for world in (4, 2):
            t0 = time.perf_counter()
            ranks[world] = MS.run_ranks(
                lm_mesh_rank, world, args=(str(workdir), world, seed),
                backend="gloo", timeout=LM_MESH_TIMEOUT, workdir=workdir,
                threads=max(1, (os.cpu_count() or 1) // world))
            rec[f"world{world}_s"] = time.perf_counter() - t0
            print(f"  world of {world} ranks (gloo, one card): "
                  f"{rec[f'world{world}_s']:.1f} s")
        rec["jamba_bf16"] = jamba_bf16_check(cfgs["jamba_bf16"], workdir,
                                             seed, dev)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    r4, r2 = ranks[4], ranks[2]
    for name in r4[0]["walls"]:
        walls = [r["walls"][name] for r in r4]
        peaks = [r["peaks"].get(name) for r in r4]
        by_op = r4[0]["by_op"].get(name, {})
        print(f"  {name}: wall {max(walls):.2f} s, per-rank peak "
              f"{peak_text(peaks) if None not in peaks else 'n/a'}, rank 0's "
              f"collectives by op {by_op} ({card})")
    for name in r2[0]["walls"]:
        print(f"  {name} (world of 2): wall "
              f"{max(r['walls'][name] for r in r2):.2f} s, rank 0's "
              f"collectives by op {r2[0]['by_op'].get(name, {})}")
    # every arch's SMOKE gradients on (2, 2) against one rank
    zoo = {a: max((r["zoo_grad_rel"][a] for r in r4),
                  key=lambda v: (not isinstance(v, float), v))
           for a in r4[0]["zoo_grad_rel"]}
    print("  SMOKE gradients (f32) on (2, 2) vs one rank, max |diff| / max "
          "|one rank| over the leaves and ranks (tolerance "
          f"{LM_MESH_GRAD_RTOL:g}): " + ", ".join(
              f"{a} {v:.2e}" if isinstance(v, float) else f"{a} {v}"
              for a, v in zoo.items()))
    bad = [a for a, v in zoo.items()
           if not (isinstance(v, float) and v <= LM_MESH_GRAD_RTOL)]
    if bad:
        fail(f"SMOKE gradients on (2, 2) disagree with one rank: {bad}")
    rec["zoo_grad_rel"] = zoo
    # the f32 pairs against one rank
    for name in ("internvl_f32", "moonlight_f32"):
        got = {k: max(r[f"{name}_{k}"] for r in r4)
               for k in ("loss_rel", "grad_norm_rel", "param_err",
                         "grad_rel")}
        print(f"  {name} on the mesh vs one rank: loss rel "
              f"{got['loss_rel']:.3e} and grad norm rel "
              f"{got['grad_norm_rel']:.3e} (tolerance "
              f"{LM_MESH_LOSS_RTOL:g}), max |param diff| "
              f"{got['param_err']:.3e} (tolerance {LM_MESH_PARAM_ATOL:g}), "
              f"gradients max |diff| / max |one rank| over the leaves "
              f"{got['grad_rel']:.3e} (tolerance {LM_MESH_GRAD_RTOL:g})")
        if (max(got["loss_rel"], got["grad_norm_rel"]) > LM_MESH_LOSS_RTOL
                or got["param_err"] > LM_MESH_PARAM_ATOL
                or got["grad_rel"] > LM_MESH_GRAD_RTOL):
            fail(f"{name}: the mesh step disagrees with one rank")
        rec[name] = got
    jrel = max(r["jamba_rel"] for r in r4)
    print(f"  Jamba (one period, experts at capacity factor 64, f32 "
          f"activations) prefill on "
          f"(2, 2) vs one rank: last-position logits max |diff| / max|one "
          f"rank| {jrel:.3e} (tolerance {JAMBA_MESH_RTOL:g})")
    if jrel > JAMBA_MESH_RTOL:
        fail("Jamba's mesh prefill disagrees with one rank")
    rec["jamba_rel"] = jrel
    # collectives by op against the fake-world lowering of the same step
    for name, world_ranks in (("stablelm_bf16", r4),
                              ("stablelm_2l_1x2", r2)):
        got = world_ranks[0]["by_op"][name]
        print(f"  {name}: the card's rank 0 by op {got}; lowered in a fake "
              f"world {lowered[name]}")
        if got != lowered[name]:
            fail(f"{name}: the card's collectives differ from the lowered "
                 "step's")
    rec["lowered_by_op"] = lowered
    # elastic restore, and one rank here
    for key in ("elastic_2x2_bitwise",):
        if not all(r[key] for r in r4):
            fail(f"{key}: a rank's restored block is not its saved block")
    if not all(r["elastic_2x1_bitwise"] for r in r2):
        fail("elastic restore onto (2, 1): a block is not bitwise")
    print("  elastic: saved on (4, 1), restored on (2, 2) and (2, 1), "
          "every rank's block bitwise its slice of the params")
    # the dry run's LM rows, one per mesh, against the CPU's (pinned)
    rec["dryrun"] = lm_dryrun_rows(card)
    rec["ranks"] = {4: r4, 2: r2}
    launches = {}
    for world, rk in ranks.items():
        for r in rk:
            for name, counts in r["launches"].items():
                tot = launches.setdefault(f"lm_mesh_{name}", {})
                for k, v in counts.items():
                    tot[k] = tot.get(k, 0) + v
    # InternVL2's decoder takes the ring (plain products, no kernel)
    for name, need in (("moonlight_bf16", ("flash_attention",
                                           "flash_attention_bwd")),
                       ("jamba", ("flash_attention", "selective_scan")),
                       ("jamba_bf16", ("flash_attention", "selective_scan")),
                       ("stablelm_bf16", ("flash_attention",
                                          "flash_attention_bwd"))):
        require_launches(f"phase 14 {name}", launches[f"lm_mesh_{name}"],
                         need)
    return rec, launches


def jamba_bf16_check(cfg, workdir: Path, seed: int, dev) -> dict:
    """Jamba's bf16 prefill on the mesh (saved by rank 0) against one rank
    here: the first MoE layer's output against ``moe_dense`` on the mesh's
    own input; against the one-rank prefill, the tokens whose experts
    differ (the witness that bf16 summation order re-routes them), the
    output's error on the tokens that agree, and the last position's
    logits (printed). Fails where a held reading is out of bounds."""
    from repro_torch.models import api
    from repro_torch.models import moe as MOE
    mesh = torch.load(workdir / "mesh_jamba_bf16.pt")
    rows, seq = JAMBA_PREFILL
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    batch = train_batches(cfg, rows, seq, seed, dev)()
    with first_moe_call({}) as cap, torch.no_grad():
        _, logits = api.make_prefill_step(cfg)(params,
                                              {"tokens": batch["tokens"]})
        xm, ym = (mesh[k].to(dev) for k in ("x", "y"))
        y_same, _ = MOE.moe_dense(cfg, cap["p"], xm)
        d = xm.shape[-1]
        sets = [torch.sort(MOE._route(cfg, cap["p"], t.reshape(-1, d))[1],
                           dim=-1).values for t in (cap["x"], xm)]
    agree = (sets[0] == sets[1]).all(-1)
    y1 = cap["y"].reshape(-1, d).float()
    dy = (ym.reshape(-1, d).float() - y1).abs()
    scale = y1.abs().max().item()
    out = {
        "a2a_rel": ((ym.float() - y_same.float()).abs().max().item()
                    / y_same.float().abs().max().item()),
        "tokens": int(agree.numel()),
        "rerouted": int((~agree).sum().item()),
        "agree_rel": (dy[agree].max().item() / scale if agree.any()
                      else float("inf")),
        "all_rel": dy.max().item() / scale,
        "logits_rel": ((mesh["logits"].to(dev).float() - logits.float())
                       .abs().max().item()
                       / logits.float().abs().max().item())}
    out["agree_share"] = 1 - out["rerouted"] / out["tokens"]
    print(f"  Jamba bf16 prefill on (2, 2), first MoE layer: the mesh's "
          f"output vs one rank's moe_dense on the same input max |diff| / "
          f"max {out['a2a_rel']:.3e} (tolerance {JAMBA_BF16_A2A_RTOL:g}); "
          f"vs the one-rank prefill {out['rerouted']} of {out['tokens']} "
          f"tokens routed to other experts (share agreeing "
          f"{out['agree_share']:.4f}, least {JAMBA_BF16_AGREE_MIN:g}), "
          f"error on the agreeing tokens {out['agree_rel']:.3e} "
          f"(tolerance {JAMBA_BF16_AGREE_RTOL:g}), on all "
          f"{out['all_rel']:.3e}; last-position logits "
          f"{out['logits_rel']:.3e} (not held)")
    if (out["a2a_rel"] > JAMBA_BF16_A2A_RTOL
            or out["agree_share"] < JAMBA_BF16_AGREE_MIN
            or out["agree_rel"] > JAMBA_BF16_AGREE_RTOL):
        fail("Jamba's bf16 mesh prefill disagrees with one rank")
    del params, batch, logits, cap, mesh
    torch.cuda.empty_cache()
    return out


def lm_dryrun_pins() -> dict:
    """``LM_PINS`` of tests/test_torch_mesh_lm.py, read without running it."""
    import ast
    src = (ROOT / "tests" / "test_torch_mesh_lm.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "LM_PINS":
            return ast.literal_eval(node.value)
    fail("tests/test_torch_mesh_lm.py has no LM_PINS")


def lm_dryrun_rows(card: str) -> dict:
    """One LM dry-run row per production mesh, lowered here, against the
    CPU's (``LM_PINS``, taken with torch 2.13): every pinned key equal,
    the collectives too (where DTensor's planner could choose, the loss
    settles its partial sums itself, so torch 2.11 and 2.13 place the
    same collectives)."""
    from repro_torch.launch import dryrun as DR
    pins = lm_dryrun_pins()
    out = {}
    for key, want in pins.items():
        arch, shape, tag = key.split("__")
        t0 = time.perf_counter()
        _, row = DR.lower_cell(arch, shape, tag == "multi")
        print(f"  dry-run row {key} ({time.perf_counter() - t0:.1f} s, "
              f"{card}):")
        for k in want:
            print(f"    {k}: card {row[k]}, CPU {want[k]}")
        bad = [k for k in want if row[k] != want[k]]
        if bad:
            fail(f"dry-run row {key}: {bad} differ from the CPU's")
        out[key] = row
    return out

# ---------------------------------------------------------------------------
# Phase 15: the LM side's refusals lifted: the scan at a 16-bit scan_dtype,
# forward and backward (ROADMAP item 14e), the scan at every d_state up to
# 64, bf16 attention at every head dim up to 256
# ---------------------------------------------------------------------------

# the scan's 16-bit forms against the plain tree (ref.selective_scan_tree)
# on the card, y, h_last and the saved states within TREE_TOL x max|plain|,
# the limit the CPU tests hold the plain tree to against the reference: the
# same rounded combines in the same order; what is left is y's f32 sum over
# the states in another order and a decay or state whose last f32 bit
# differs (an FMA) rounding the other way, 2^-8 of one term
TREE_TOL = 2e-3
# their backward against its algorithm in plain code (backward_chunks) on
# the card: the same f32 adjoint at the same rounded transitions; f32 sums
# in another order, and a state rounded the other way in dC's R(h)
TREE_BWD_TOL = 1e-3
# ... and against autograd of the plain tree, which rounds each cotangent
# to the 16-bit type where the kernel keeps f32 (ROADMAP Queue 3): the CPU
# tests' GRAD_TOL (read there up to 1.6e-2 in bf16, 2.7e-3 in f16)
TREE_GRAD_TOL = {"bfloat16": 3e-2, "float16": 6e-3}
# Jamba one period at scan_dtype bf16, prefill logits against the same
# params and prompts at scan_dtype f32: max|diff| / max|f32|. A bf16
# transition holds 8 bits, so a chunk's 64 rounded combines move a scan's
# y by about 1e-2 of its max against the f32 scan; the limit leaves room
# for eight layers of that in bf16 activations
SCAN_DTYPE_LOGIT_TOL = 5e-2
# every attention arch's SMOKE config in bf16, card against CPU from the
# same state and batch: prefill logits within BF16_SMOKE_LOGIT_TOL x
# max|CPU|, a train step's loss and grad norm within BF16_SMOKE_TRAIN_TOL
# of the CPU's. Both sides round bf16 products and activations, in other
# orders: bf16 against f32 on the CPU reads 2.5e-3 to 9.5e-3 on the
# logits, up to 4.9e-5 on the loss and 1.9e-3 on the grad norm
BF16_SMOKE_LOGIT_TOL = 2e-2
BF16_SMOKE_TRAIN_TOL = 1e-2
# the archs whose path runs the attention kernel, at their SMOKE head dims
# (16 to 32)
ATTENTION_ARCHS = ("stablelm-1.6b", "phi3-medium-14b", "nemotron-4-15b",
                   "gemma-2b", "whisper-large-v3", "internvl2-1b",
                   "moonshot-v1-16b-a3b", "arctic-480b", "jamba-v0.1-52b")
SHORT = {"bfloat16": "bf16", "float16": "f16"}


def scan_cfg(cfg, **ssm):
    """``cfg`` with its SSM config's fields replaced."""
    import dataclasses
    return cfg.with_overrides(ssm=dataclasses.replace(cfg.ssm, **ssm))


def check_scan_geometry(d_states=range(1, 65)) -> None:
    """The wrapper's instance, groups, lanes, channels and shared memory of
    every d_state of ``d_states``, forward (both forms) and backward,
    against the CUDA side's (``selective_scan_geometry`` and
    ``selective_scan_bwd_geometry``), and its lanes against
    ``selective_scan_lanes``; a d_state past 256 refused on both sides."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import selective_scan as SS
    fwd = _build.load("selective_scan")
    for ds in d_states:
        for backward in (False, True):
            want = SS.bwd_geometry(ds) if backward else SS.geometry(ds)
            got = SS.kernel_geometry(ds, backward)
            if got != want:
                fail(f"selective_scan{'_bwd' if backward else ''} geometry "
                     f"at d_state {ds}: kernel {got}, wrapper {want}")
        if fwd.selective_scan_lanes(ds) != SS.lanes(ds):
            fail(f"selective_scan lanes at d_state {ds}")
    top = SS.D_STATES[-1] + 1
    if SS.kernel_geometry(top) is not None or SS.kernel_geometry(
            top, True) is not None:
        fail(f"selective_scan: the CUDA side takes d_state {top}")
    print(f"  selective_scan: instance, groups, lanes, channels and shared "
          f"memory of d_state {d_states[0]} to {d_states[-1]}, forward and "
          f"backward, equal on both sides; {top} refused")


def check_scan_forms(g, dev):
    """The scan's bf16 and f16 forms (the tree kernel) against the plain
    tree on the card: at Jamba's full width (di 8192, ds 16) the prefill
    (B 4, T 2048, no h0: the row; and with h0), a decode step and a ragged
    T = 1000 (one chunk of 1000 steps: the high counter), then d_state 1,
    12, 48 and 64; y, h_last and the saved chunk states within TREE_TOL;
    then the f32 scan at d_state 1, 12 and 48 (instances 4, 16, 64, the
    states past ds masked) against its plain version within SCAN_TOL.
    Returns (two kernel rows, records)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as SS
    rows, recs = [], []
    for sd in ("bfloat16", "float16"):
        for label, B, T, di, ds, with_h0 in (
                ("no h0", 4, 2048, 8192, 16, False),
                ("with h0", 4, 2048, 8192, 16, True),
                ("decode step, with h0", 4, 1, 8192, 16, True),
                ("ragged T, with h0", 2, 1000, 8192, 16, True),
                ("d_state 1, with h0", 1, 300, 1000, 1, True),
                ("d_state 12, ragged T and di, with h0", 2, 100, 1030, 12,
                 True),
                ("d_state 48", 1, 256, 520, 48, False),
                ("d_state 64, with h0", 2, 128, 8192, 64, True)):
            dt, dx, A, Bc, Cc = _scan_inputs(g, dev, B, T, di, ds, 4.6)
            h = (torch.randn(B, di, ds, generator=g, device=dev)
                 if with_h0 else None)
            y, hl, hs = SS.selective_scan(dt, dx, A, Bc, Cc, h,
                                          save_states=True, scan_dtype=sd)
            wy, wh, starts = ref.selective_scan_tree(dt, dx, A, Bc, Cc, h,
                                                     sd, every=SS.BT)
            name = (f"selective_scan {SHORT[sd]} {label} B={B} T={T} "
                    f"di={di} ds={ds}")
            err = max(compare(f"{name} {what}", a, w, TREE_TOL)
                      for what, a, w in (("y", y, wy), ("h_last", hl, wh),
                                         ("saved states", hs,
                                          torch.stack(starts, 1))))
            del hs, starts, y, hl, wy, wh
            b_ms, b_by = bound("selective_scan", B=B, T=T, di=di, ds=ds,
                               h0=with_h0, scan_dtype=sd)
            recs.append(dict(
                case=f"{label} B={B} T={T} di={di} ds={ds} {sd}",
                max_abs_err=err,
                ms=cuda_ms(lambda: SS.selective_scan(
                    dt, dx, A, Bc, Cc, h, scan_dtype=sd), 10),
                plain_ms=(cuda_ms(lambda: ref.selective_scan(
                    dt, dx, A, Bc, Cc, h, sd), 1) if label == "no h0"
                    else None),
                bound_ms=b_ms, bound_by=b_by, library_ms=None))
            del dt, dx, A, Bc, Cc, h
            torch.cuda.empty_cache()
        first = next(r for r in recs if r["case"].startswith("no h0")
                     and r["case"].endswith(" " + sd))
        rows.append(dict(
            name=f"selective_scan_{SHORT[sd]}", route="cuda",
            source="src/repro_torch/csrc/selective_scan.cu",
            replaces="src/repro/kernels/selective_scan.py:69",
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")}))
    for B, T, di, ds in ((1, 300, 1000, 1), (2, 100, 1030, 12),
                         (1, 256, 520, 48)):
        dt, dx, A, Bc, Cc = _scan_inputs(g, dev, B, T, di, ds, 4.6)
        h = torch.randn(B, di, ds, generator=g, device=dev)
        y, hl = SS.selective_scan(dt, dx, A, Bc, Cc, h)
        wy, wh = ref.selective_scan(dt, dx, A, Bc, Cc, h)
        for what, a, w in (("y", y, wy), ("h_last", hl, wh)):
            compare(f"selective_scan f32 d_state {ds} (instance "
                    f"{SS.instance(ds)}) {what} B={B} T={T} di={di}", a, w,
                    SCAN_TOL)
    check_scan_geometry()
    return rows, recs


def check_scan_bwd_forms(g, dev):
    """The backward of the scan's bf16 and f16 forms: at a Jamba
    micro-batch's training shape (B 1, T 4096, di 8192, ds 16, 8 segments)
    against backward_chunks on the card within TREE_BWD_TOL, bitwise
    repeatable, timed beside the f32 form and the bound (the rows); the
    f32 backward's 64-state instance at that shape but d_state 64 against
    backward_chunks (SCAN_BWD_TOL), timed; at ragged T with several
    segments, h0 and dh_last, at d_state 1, 12, 48 and 64, the 16-bit forms
    against backward_chunks and autograd of the plain tree
    (TREE_GRAD_TOL), the f32 one against autograd of the plain f32 scan
    (SCAN_BWD_TOL). No single PyTorch call computes it. Returns (two
    kernel rows, records)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import registry
    from repro_torch.kernels import selective_scan as SS
    grads = ("d(dt)", "d(dx)", "dA", "dB", "dC", "dh0")

    def held(label, got, want, tol):
        rel = 0.0
        for name, a, w in zip(grads, got, want):
            if a is None:
                continue
            r = (a - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            rel = max(rel, r)
            if r > tol:
                fail(f"{label} {name}: max|diff| / max|plain| {r:.3e} "
                     f"above {tol:g}")
        return rel

    rows, recs = [], []
    B, T, di, ds = 1, 4096, 8192, 16
    cfg = dict(B=B, T=T, di=di, ds=ds)
    for sd in ("bfloat16", "float16"):
        dt, dx, A, Bc, Cc = _scan_inputs(g, dev, B, T, di, ds, 4.6)
        dy = torch.randn(B, T, di, generator=g, device=dev)
        _, _, hs = SS.selective_scan(dt, dx, A, Bc, Cc, save_states=True,
                                     scan_dtype=sd)

        def run(sd=sd, hs=hs):
            return SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy,
                                         scan_dtype=sd)
        got, again = run(), run()
        label = (f"selective_scan_bwd {SHORT[sd]} B={B} T={T} di={di} "
                 f"ds={ds} ({SS.n_segments(T)} segments)")
        if not all(torch.equal(a, b) for a, b in zip(got[:5], again[:5])):
            fail(f"{label}: not bitwise repeatable")
        _sync(dev)
        t0 = time.perf_counter()
        want = SS.backward_chunks(dt, dx, A, Bc, Cc, dy, scan_dtype=sd)
        _sync(dev)
        plain_ms = (time.perf_counter() - t0) * 1e3
        rel = held(label, got, want, TREE_BWD_TOL)
        err = max((a - w).abs().max().item()
                  for a, w in zip(got[:5], want[:5]))
        b_ms, b_by = bound("selective_scan_bwd", **cfg, scan_dtype=sd)
        nbytes = registry.get("selective_scan_bwd").cost(
            dict(cfg, scan_dtype=sd))[1]
        ms = cuda_ms(run, 5)
        f32_ms = cuda_ms(lambda: SS.selective_scan_bwd(
            dt, dx, A, Bc, Cc, hs, dy), 5)
        fwd_ms = cuda_ms(lambda: SS.selective_scan(
            dt, dx, A, Bc, Cc, save_states=True, scan_dtype=sd), 5)
        print(f"  {label}: against backward_chunks max|diff| / max|plain| "
              f"{rel:.3e} (tolerance {TREE_BWD_TOL:g}), bitwise repeatable; "
              f"kernel {ms:.3f} ms (the f32 form on the same inputs "
              f"{f32_ms:.3f} ms), {nbytes / ms / 1e6:.1f} GB/s, "
              f"{b_ms / ms:.3f} of the bound {b_ms:.4f} ms ({b_by}); "
              f"backward_chunks (one run, host clock) {plain_ms:.1f} ms; "
              f"forward saving the chunk states {fwd_ms:.4f} ms")
        rows.append(dict(
            name=f"selective_scan_bwd_{SHORT[sd]}", route="cuda",
            source="src/repro_torch/csrc/selective_scan_bwd.cu",
            replaces="src/repro/kernels/selective_scan.py:69",
            max_abs_err=err, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            f32_form_ms=f32_ms, fwd_states_ms=fwd_ms))
        del dt, dx, A, Bc, Cc, dy, hs, got, again, want
        torch.cuda.empty_cache()
    # the f32 backward's 64-state instance (32 channels a block) at a
    # Jamba micro-batch's shape but d_state 64, against backward_chunks
    dt, dx, A, Bc, Cc = _scan_inputs(g, dev, 1, 4096, 8192, 64, 4.6)
    dy = torch.randn(1, 4096, 8192, generator=g, device=dev)
    _, _, hs = SS.selective_scan(dt, dx, A, Bc, Cc, save_states=True)

    def run64():
        return SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy)
    got = run64()
    label = "selective_scan_bwd f32 B=1 T=4096 di=8192 ds=64 (8 segments)"
    if not all(torch.equal(a, b) for a, b in zip(got[:5], run64()[:5])):
        fail(f"{label}: not bitwise repeatable")
    _sync(dev)
    t0 = time.perf_counter()
    want = SS.backward_chunks(dt, dx, A, Bc, Cc, dy)
    _sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    rel = held(label, got, want, SCAN_BWD_TOL)
    b_ms, b_by = bound("selective_scan_bwd", B=1, T=4096, di=8192, ds=64)
    ms = cuda_ms(run64, 5)
    print(f"  {label}: against backward_chunks max|diff| / max|plain| "
          f"{rel:.3e} (tolerance {SCAN_BWD_TOL:g}), bitwise repeatable; "
          f"kernel {ms:.3f} ms, {b_ms / ms:.3f} of the bound {b_ms:.4f} ms "
          f"({b_by}); backward_chunks (one run, host clock) "
          f"{plain_ms:.1f} ms")
    recs.append(dict(case=label, max_rel_err=rel, ms=ms, plain_ms=plain_ms,
                     bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del dt, dx, A, Bc, Cc, dy, hs, got, want
    torch.cuda.empty_cache()
    for sd in ("bfloat16", "float16", "float32"):
        for B, T, di, ds in ((2, 300, 40, 1), (2, 1000, 200, 12),
                             (1, 700, 66, 48), (1, 500, 64, 64)):
            dt, dx, A, Bc, Cc = _scan_inputs(g, dev, B, T, di, ds, 2.0)
            h0, dh = (torch.randn(B, di, ds, generator=g, device=dev)
                      for _ in range(2))
            dy = torch.randn(B, T, di, generator=g, device=dev)
            _, _, hs = SS.selective_scan(dt, dx, A, Bc, Cc, h0,
                                         save_states=True, scan_dtype=sd)
            got = SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh,
                                        want_dh0=True, scan_dtype=sd)
            again = SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh,
                                          want_dh0=True, scan_dtype=sd)
            label = (f"selective_scan_bwd {SHORT.get(sd, 'f32')} B={B} "
                     f"T={T} di={di} ds={ds} (instance {SS.instance(ds)}), "
                     f"{SS.n_segments(T)} segments, h0 and dh_last")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{label}: not bitwise repeatable")
            ins = [t.clone().requires_grad_()
                   for t in (dt, dx, A, Bc, Cc, h0)]
            y, h_last = ref.selective_scan(*ins, scan_dtype=sd)
            plain = torch.autograd.grad([y, h_last], ins, [dy, dh])
            if sd == "float32":
                rel = held(label, got, plain, SCAN_BWD_TOL)
                note = (f"against autograd of the plain scan (tolerance "
                        f"{SCAN_BWD_TOL:g})")
            else:
                want = SS.backward_chunks(dt, dx, A, Bc, Cc, dy, h0, dh,
                                          scan_dtype=sd)
                rel = held(label, got, want, TREE_BWD_TOL)
                rel_p = held(label, got, plain, TREE_GRAD_TOL[sd])
                note = (f"against backward_chunks (tolerance "
                        f"{TREE_BWD_TOL:g}); against autograd of the plain "
                        f"tree {rel_p:.3e} (tolerance {TREE_GRAD_TOL[sd]:g})")
            print(f"  {label}: max|diff| / max|plain| {rel:.3e} {note}, "
                  f"bitwise repeatable")
            recs.append(dict(case=label, max_rel_err=rel))
    return rows, recs


def check_attention_head_dims(g, dev):
    """bf16 attention at every head dim the earlier phases leave out (16 to
    240 but 64, 128 and 192; hd 256 is Gemma's), B 2, S 1000 (ragged), H
    8, KVH 2, each on the instance of its width: the forward against the
    plain version (compare_bf16), timed beside SDPA and the bound; the
    backward bitwise repeatable and against backward_blocks in f32 (the
    tensor cores at every bf16 head dim; 144 to 176 on the width-256
    instance), within ATT_BWD_BF16_TOL, timed beside SDPA's backward and
    the bound. Returns records."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, S, H, KVH = 2, 1000, 8, 2
    recs = []
    for hd in range(16, 257, 16):     # the other head dims: phase 17
        if hd in (64, 128, 192, 256):
            continue
        q, k, v, do = (torch.randn(B, S, n, hd, generator=g, device=dev)
                       .to(torch.bfloat16) for n in (H, KVH, KVH, H))
        label = (f"B={B} S={S} H={H} KVH={KVH} hd={hd} bf16 (width "
                 f"{FA.tc_width(hd)})")
        err = compare_bf16(f"flash_attention {label}",
                           FA.flash_attention(q, k, v),
                           ref.flash_attention(q.float(), k.float(),
                                               v.float()))
        o, lse = FA.flash_attention(q, k, v, lse=True)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do)
        again = FA.flash_attention_bwd(q, k, v, o, lse, do)
        scope = FA.bwd_scope(torch.bfloat16, hd)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_bwd {label}: not bitwise repeatable")
        want = FA.backward_blocks(q.float(), k.float(), v.float(),
                                  o.float(), lse, do.float())
        b_err, b_rel = _rel_errs(got, want, f"flash_attention_bwd {label}",
                                 ATT_BWD_BF16_TOL)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        cfg = dict(B=B, S=S, H=H, KVH=KVH, hd=hd, dtype="bfloat16")
        f_ms, f_by = bound("flash_attention", **cfg)
        g_ms, g_by = bound("flash_attention_bwd", **cfg)
        rec = dict(
            case=label, max_abs_err=err, bwd_scope=scope,
            bwd_max_abs_err=b_err, bwd_max_rel_err=b_rel,
            ms=cuda_ms(lambda: FA.flash_attention(q, k, v), 10),
            plain_ms=cuda_ms(lambda: ref.flash_attention(q, k, v), 3),
            bound_ms=f_ms, bound_by=f_by,
            library_ms=cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                            enable_gqa=True), 10),
            bwd_ms=cuda_ms(lambda: FA.flash_attention_bwd(
                q, k, v, o, lse, do), 10),
            bwd_bound_ms=g_ms, bwd_bound_by=g_by,
            bwd_library_ms=cuda_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True), 10))
        print(f"  flash_attention_bwd {label} ({scope}): max|diff| / "
              f"max|plain| {b_rel:.3e} against backward_blocks in f32 "
              f"(tolerance "
              f"{ATT_BWD_BF16_TOL:g}), bitwise repeatable; forward "
              f"{rec['ms']:.4f} ms (SDPA {rec['library_ms']:.4f}, bound "
              f"{f_ms:.4f}), backward {rec['bwd_ms']:.4f} ms (SDPA "
              f"{rec['bwd_library_ms']:.4f}, bound {g_ms:.4f})")
        recs.append(rec)
        del q, k, v, do, o, lse, got, again, want, qt, kt, vt, out
        torch.cuda.empty_cache()
    return recs


def jamba_scan_dtype_steps(seed: int, dev):
    """Jamba v0.1 without experts, one period (8 layers) at full width,
    bf16 params and activations, scan_dtype bf16: a prefill of 4 x 2048
    and 16 decode steps (``hybrid_steps``) with the launch counts set to 0
    just before and read just after; then the same params and prompts at
    scan_dtype f32, whose prefill logits the bf16 ones are held to within
    SCAN_DTYPE_LOGIT_TOL. Returns (record, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config("jamba-v0.1-52b").with_overrides(moe=None, n_layers=8)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(seed)
    reset_counts()
    r = hybrid_steps(scan_cfg(cfg, scan_dtype="bfloat16"), 4, 2048, 17, g,
                     dev)
    launches = read_counts()
    label = ("Jamba v0.1 without experts, one period (8 layers), bf16, "
             "scan_dtype bf16")
    require_launches(label, launches, ("flash_attention",
                                       "selective_scan_bf16"))
    check_finite(label, r["prefill_logits"], r["last_logits"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    _, want = api.make_prefill_step(cfg)(r["params"],
                                          {"tokens": r["prompts"]})
    got = r["prefill_logits"].float()
    want = want.float()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    steps = r["tokens"].shape[1] - 1
    rec = {"prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
           "prefill_tok_s": 4 * 2048 / r["prefill_s"],
           "decode_tok_s": 4 * steps / r["decode_s"], "peak_mem_gb": peak_gb,
           "logits_vs_f32_scan": rel, "launches": launches}
    print(f"  {label}: prefill 4x2048 in {r['prefill_s']:.3f} s "
          f"({rec['prefill_tok_s']:.0f} tok/s), {steps} decode steps in "
          f"{r['decode_s']:.3f} s ({rec['decode_tok_s']:.1f} tok/s), peak "
          f"{peak_gb:.2f} GB; prefill logits against scan_dtype f32 on the "
          f"same params: max|diff| / max|f32| {rel:.3e} (tolerance "
          f"{SCAN_DTYPE_LOGIT_TOL:g}) {'ok' if rel <= SCAN_DTYPE_LOGIT_TOL else 'DISAGREES'}; "
          f"launches { {k: v for k, v in launches.items() if v} }")
    if rel > SCAN_DTYPE_LOGIT_TOL:
        fail(f"{label}: logits disagree with scan_dtype f32")
    del r, got, want
    torch.cuda.empty_cache()
    return rec, launches


def bf16_smoke_vs_cpu(seed: int, dev, cases=None):
    """Every ATTENTION_ARCHS SMOKE config in bf16 (params and
    activations; head dims 16 to 32, the instances phase 15 adds), or each
    of ``cases`` ((arch, config overrides, the prefill's kernels, the
    step's kernels)), card against CPU from the same state and batch: the
    prefill's logits within BF16_SMOKE_LOGIT_TOL x max|CPU|, then one
    make_train_step whose loss and grad norm are within
    BF16_SMOKE_TRAIN_TOL of the CPU's. The card's prefill and step are
    main-path runs, their launches counted. Returns (record, launches by
    run)."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    if cases is None:
        cases = tuple((arch, {}, ("flash_attention",),
                       ("flash_attention", "flash_attention_bwd"))
                      for arch in ATTENTION_ARCHS)
    rec, paths = {}, {}
    for arch, over, p_needs, t_needs in cases:
        cfg = get_config(arch, smoke=True).with_overrides(
            param_dtype="bfloat16", activation_dtype="bfloat16", **over)
        st_cpu = api.init_state(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
        st_dev = _tree_to(st_cpu, dev)
        b = train_batches(cfg, 4, 64, seed, "cpu")()
        inputs = {k: v for k, v in b.items() if k != "labels"}
        prefill = api.make_prefill_step(cfg)
        reset_counts()
        _, l_dev = prefill(st_dev["params"], _tree_to(inputs, dev))
        p_launches = read_counts()
        _, l_cpu = prefill(st_cpu["params"], inputs)
        step = api.make_train_step(cfg)
        reset_counts()
        _, m_dev = step(st_dev, _tree_to(b, dev))
        t_launches = read_counts()
        _, m_cpu = step(st_cpu, b)
        label = f"{arch} SMOKE bf16 (hd {cfg.resolved_head_dim()})"
        require_launches(f"{label} prefill", p_launches, p_needs)
        require_launches(f"{label} train step", t_launches, t_needs)
        l_dev, l_cpu = l_dev.float().cpu(), l_cpu.float()
        check_finite(label, l_dev)
        worst = {"logits": ((l_dev - l_cpu).abs().max()
                            / l_cpu.abs().max()).item()}
        for k in ("loss", "grad_norm"):
            worst[k] = abs(float(m_dev[k]) - float(m_cpu[k])) / abs(
                float(m_cpu[k]))
        ok = (worst["logits"] <= BF16_SMOKE_LOGIT_TOL
              and worst["loss"] <= BF16_SMOKE_TRAIN_TOL
              and worst["grad_norm"] <= BF16_SMOKE_TRAIN_TOL)
        print(f"  {label}, card vs CPU: prefill logits max|diff| / max|CPU| "
              f"{worst['logits']:.2e} (tolerance {BF16_SMOKE_LOGIT_TOL:g}); "
              f"train step loss {worst['loss']:.2e}, grad norm "
              f"{worst['grad_norm']:.2e} (tolerance "
              f"{BF16_SMOKE_TRAIN_TOL:g})  {'ok' if ok else 'DISAGREES'}")
        if not ok:
            fail(f"{label}: card and CPU disagree")
        rec[label] = worst
        paths[f"{label} prefill"] = p_launches
        paths[f"{label} train step"] = t_launches
    return rec, paths


def f16_scan_smoke_vs_cpu(seed: int, dev, sd: str = "float16",
                          d_state: int = 0, needs=("selective_scan_f16",
                                                   "selective_scan_bwd_f16")):
    """Jamba SMOKE without experts at scan_dtype ``sd`` (f16; f32 params;
    its d_state, or ``d_state``), card against CPU: the prefill's logits
    within LOGIT_TOL x max|CPU| (the tree kernel against the plain tree,
    the same rounded combines), three decode steps' logits the same; one
    train step's loss within SMOKE_TRAIN_TOL and its grad norm within
    TREE_GRAD_TOL[sd] (the CPU's autograd of the plain tree rounds its
    cotangents to the 16-bit type, the kernel does not). The card's runs
    are main-path runs, which must launch ``needs``. Returns (record,
    launches)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import api
    cfg = get_config("jamba-v0.1-52b", smoke=True).with_overrides(moe=None)
    cfg = scan_cfg(cfg, scan_dtype=sd, d_state=d_state or cfg.ssm.d_state)
    st_cpu = api.init_state(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    st_dev = _tree_to(st_cpu, dev)
    b = train_batches(cfg, 4, 64, seed, "cpu")()
    prefill, decode = api.make_prefill_step(cfg), api.make_decode_step(cfg)
    step = api.make_train_step(cfg)
    reset_counts()
    _, l_dev = prefill(st_dev["params"], {"tokens": b["tokens"].to(dev)})
    cache = api.zero_cache(cfg, ShapeConfig("t", 8, 4, "decode"), dev)
    decoded = []
    for t in range(3):
        cache, lg = decode(st_dev["params"], cache,
                           {"token": b["tokens"][:, t].to(dev), "pos": t})
        decoded.append(lg.cpu())
    _, m_dev = step(st_dev, _tree_to(b, dev))
    launches = read_counts()
    label = (f"Jamba SMOKE scan_dtype {SHORT[sd]}"
             + (f" d_state {d_state}" if d_state else ""))
    require_launches(label, launches, needs)
    _, l_cpu = prefill(st_cpu["params"], {"tokens": b["tokens"]})
    cache = api.zero_cache(cfg, ShapeConfig("t", 8, 4, "decode"), "cpu")
    err = compare(f"{label} prefill logits, card vs CPU", l_dev.cpu(), l_cpu,
                  LOGIT_TOL)
    for t in range(3):
        cache, lg = decode(st_cpu["params"], cache,
                           {"token": b["tokens"][:, t], "pos": t})
        err = max(err, compare(f"{label} decode step {t} logits, card vs "
                               f"CPU", decoded[t], lg, LOGIT_TOL))
    _, m_cpu = step(st_cpu, b)
    loss = abs(float(m_dev["loss"]) - float(m_cpu["loss"])) / abs(
        float(m_cpu["loss"]))
    norm = abs(float(m_dev["grad_norm"]) - float(m_cpu["grad_norm"])) / abs(
        float(m_cpu["grad_norm"]))
    ok = loss <= SMOKE_TRAIN_TOL and norm <= TREE_GRAD_TOL[sd]
    print(f"  {label} train step, card vs CPU: loss {loss:.2e} (tolerance "
          f"{SMOKE_TRAIN_TOL:g}), grad norm {norm:.2e} (tolerance "
          f"{TREE_GRAD_TOL[sd]:g})  {'ok' if ok else 'DISAGREES'}")
    if not ok:
        fail(f"{label} train step: card and CPU disagree")
    return {"logits_max_abs_err": err, "loss": loss, "grad_norm": norm,
            "launches": launches}, launches


def refusals_phase(seed: int, dev):
    """Phase 15: the new kernel forms against their plain versions, then
    the main-path runs that take them: Jamba one period with its scan's
    transitions in bf16 (served, then trained: 2 steps of 4 x 4096 tokens,
    grad_accum 4), every attention arch's SMOKE in bf16 (prefill and a
    train step, card vs CPU), Jamba SMOKE at scan_dtype f16 and at d_state
    64 (a train step, card vs CPU). Returns (kernel rows, launches by
    path, record)."""
    from repro_torch.configs import get_config
    rec = {}
    g = torch.Generator(device=dev).manual_seed(seed + 15)
    t0 = time.perf_counter()
    scan_rows, rec["scan_forms"] = check_scan_forms(g, dev)
    bwd_rows, rec["scan_bwd_forms"] = check_scan_bwd_forms(g, dev)
    rec["attention_head_dims"] = check_attention_head_dims(g, dev)
    rec["kernels_s"] = time.perf_counter() - t0
    paths = {}
    rec["jamba_bf16_scan_steps"], paths["jamba_bf16_scan_steps"] = (
        jamba_scan_dtype_steps(seed, dev))
    cfg = scan_cfg(get_config("jamba-v0.1-52b").with_overrides(
        moe=None, n_layers=8), scan_dtype="bfloat16")
    rec["jamba_bf16_scan_train"] = lm_train_run(
        "Jamba v0.1 without experts, one period (8 layers), bf16, "
        "scan_dtype bf16", cfg, 2, seed, dev, repeat=False)
    paths["jamba_bf16_scan_train"] = rec["jamba_bf16_scan_train"]["launches"]
    require_launches("jamba_bf16_scan_train", paths["jamba_bf16_scan_train"],
                     ("flash_attention", "flash_attention_bwd",
                      "selective_scan_bf16", "selective_scan_bwd_bf16"))
    rec["bf16_smoke"], smoke_paths = bf16_smoke_vs_cpu(seed, dev)
    paths.update(smoke_paths)
    rec["f16_scan_smoke"], paths["jamba_f16_scan_smoke"] = (
        f16_scan_smoke_vs_cpu(seed, dev))
    rec["d_state_64_smoke"] = smoke_train_vs_cpu(seed, dev, cases=(
        ("jamba-v0.1-52b d_state 64", "jamba-v0.1-52b",
         {"moe": None, "ssm": scan_cfg(get_config(
             "jamba-v0.1-52b", smoke=True), d_state=64).ssm}),))
    paths["jamba_d_state_64_smoke"] = rec["d_state_64_smoke"][
        "jamba-v0.1-52b d_state 64"]["launches"]
    torch.cuda.empty_cache()
    return scan_rows + bwd_rows, paths, rec


def phase_15_alone(args, card: str, kind: str, build_s: float,
                   ptxas_new: dict) -> int:
    """``--phase 15``: phase 15 alone after the card and build steps, its
    kernel rows' launches from its own main-path runs; writes
    chiprun_out/chip_smoke_phase15.json and prints the kernels line of its
    rows, the card and the contract line."""
    dev = torch.device("cuda")
    print(f"[15] the scan's 16-bit forms, every d_state, every bf16 head "
          f"dim ({card})")
    t0 = time.perf_counter()
    rows, paths, rec = refusals_phase(args.seed, dev)
    rec["phase_s"] = time.perf_counter() - t0
    print(f"  phase 15 {rec['phase_s']:.1f} s")
    for r in rows:
        r["launches"] = sum(p.get(r["name"], 0) for p in paths.values())
        r["on_path"] = True
        if r["launches"] == 0:
            fail(f"no main-path run launched {r['name']}")
    record = {"card": card, "build_s": build_s, "ptxas_new": ptxas_new,
              "launches": paths, "refusals": rec, "kernels": rows,
              "command_s": time.perf_counter() - T_START}
    print(f"chip_smoke: {record['command_s']:.1f} s from start")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_phase15.json").write_text(
        json.dumps(record, indent=1, default=str))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "on_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# Phase 16: the i-vector kernels' shape range. The boundary shapes of each
# new form: (D, F) at C = 2048 for gmm_loglik and bw_stats, (D, C, F) at
# K = 20 for gmm_rescore, (C, K, F) at D = 72 and (D, F) at C = 2048, K =
# 20 for gmm_align. F keeps the plain version's operands under about 8 GB
# (the plain gmm_loglik and bw_stats form [F, D^2], the plain gmm_rescore
# gathers [F, K, D^2]) and the K = C alignments short (a frame rescores C
# rows there)
P16_LOGLIK = ((205, 4096), (254, 4096), (255, 4096), (256, 4096),
              (512, 4096))
P16_BW = ((255, 8192), (256, 8192), (512, 4096))
P16_RESCORE = ((201, 2048, 2048), (256, 2048, 1024), (512, 2048, 256),
               (72, 65536, 8192))
P16_ALIGN_C = ((6273, 33, 4096), (6273, 64, 4096), (6273, 6273, 512),
               (8192, 33, 4096), (8192, 64, 4096), (8192, 8192, 1024),
               (65536, 33, 1024), (65536, 64, 1024), (65536, 65536, 128))
P16_ALIGN_D = ((235, 4096), (256, 4096), (512, 4096))
REPLACES = {"gmm_loglik": "src/repro/kernels/gmm_loglik.py:49",
            "bw_stats": "src/repro/kernels/bw_stats.py:54",
            "gmm_rescore": "src/repro/kernels/gmm_rescore.py:129",
            "gmm_align": "src/repro/kernels/gmm_align.py:162"}
# the kernels line's rows of the new forms -> the case whose shape each
# takes; hist_global runs on no main path of this script (OFF_PATH)
P16_ROWS = {"gmm_loglik_wide": "gmm_loglik D=256",
            "bw_stats_pairs": "bw_stats D=256",
            "gmm_rescore_strips": "gmm_rescore D=256 C=2048",
            "gmm_rescore_hist_global": "gmm_rescore D=72 C=65536",
            "gmm_align_wide": "gmm_align D=256 C=2048 K=20",
            "gmm_align_spill": "gmm_align D=72 C=8192 K=8192"}
# the D = 256 path: the paper's config at D = 256 (the smallest round
# width past every old limit), its corpus (utterances x frames, every
# component dealt an equal share), its serving requests, and the
# components of its card-vs-CPU check
P16_D = 256
P16_UTTS, P16_FRAMES = 128, 512
P16_REQUESTS = 32
P16_CPU_C = 64
# train_ubm at C = 8192 with the reference's default top_k=0 (K = C), on
# P16_SPILL_UTTS x 512 frames
P16_SPILL_C = 8192
P16_SPILL_UTTS = 64


def held_exact(label, got, want, exact, tol=TOL) -> float:
    """A new form's output against its plain version (f32) and against the
    plain version's formula evaluated in float64 (``exact``): held within
    tol x max|exact| of the latter, since at D in the hundreds the f32
    plain version carries the rounding of its own 10^4..10^5-term sums
    (its distance from ``exact`` is printed beside). Returns the error
    against the f32 plain version."""
    got, want = got.double(), want.double()
    err = (got - want).abs().max().item()
    e64 = (got - exact).abs().max().item()
    p64 = (want - exact).abs().max().item()
    scale = exact.abs().max().item()
    ok = e64 <= tol * scale
    print(f"  {label}: max_abs_err {e64:.3e} from the float64 value "
          f"(tolerance {tol:g} x max|value| = {tol * scale:.3e}), "
          f"{err:.3e} from the f32 plain version, whose own error is "
          f"{p64:.3e}  {'ok' if ok else 'DISAGREES'}")
    if not ok:
        fail(f"{label} disagrees with its plain version's value")
    return err


def _rows_at_once(row_bytes: int) -> int:
    """Rows of a float64 reference computed at once: about 1 GB of them."""
    return max(1, (1 << 30) // max(row_bytes, 1))


def exact_loglik(x, const, lin, Pf):
    """``ref.gmm_loglik``'s formula in float64, in frame chunks."""
    D = x.shape[1]
    out = []
    l64, P64 = lin.double(), Pf.double()
    for s in range(0, x.shape[0], _rows_at_once(8 * D * D)):
        xd = x[s:s + _rows_at_once(8 * D * D)].double()
        e = (xd[:, :, None] * xd[:, None, :]).reshape(xd.shape[0], D * D)
        out.append(const.double()[None] + xd @ l64 - 0.5 * (e @ P64.T))
    return torch.cat(out)


def exact_rescore(x, sel, A):
    """``ref.gmm_rescore``'s formula on the packed rows in float64."""
    F, D = x.shape
    E = A.shape[1]
    out = []
    step = _rows_at_once(8 * sel.shape[1] * E)
    for s in range(0, F, step):
        xd = x[s:s + step].double()
        rows = A[sel[s:s + step]].double()             # [f, K, E]
        P = rows[..., 1 + D:1 + D + D * D].reshape(*rows.shape[:2], D, D)
        q = torch.einsum("fi,fkij,fj->fk", xd, P, xd)
        out.append(rows[..., 0] + torch.einsum("fd,fkd->fk", xd,
                                               rows[..., 1:1 + D]) - 0.5 * q)
    return torch.cat(out)


def exact_fused(x, sel, A2):
    """``ref.gmm_rescore_fused``'s formula in float64: the packed
    expansion against the selected packed rows."""
    from repro_torch.kernels import ref
    out = []
    step = _rows_at_once(8 * sel.shape[1] * A2.shape[1])
    for s in range(0, x.shape[0], step):
        xe = ref.expand_quadratic(x[s:s + step]).double()
        rows = A2[sel[s:s + step]].double()            # [f, K, E2]
        out.append(torch.einsum("fe,fke->fk", xe, rows))
    return torch.cat(out)


def p16_precisions(C: int, D: int, g, dev):
    """const [C], lin [D, C], P_flat [C, D*D]: random SPD precisions."""
    P = torch.empty((C, D, D), device=dev)
    step = max(1, (1 << 28) // (D * D * 4))
    for c0 in range(0, C, step):
        a = torch.randn(min(step, C - c0), D, D, generator=g, device=dev)
        P[c0:c0 + step] = (0.3 * a @ a.transpose(1, 2) / D
                           + torch.eye(D, device=dev))
    return (torch.randn(C, generator=g, device=dev),
            torch.randn(D, C, generator=g, device=dev),
            P.reshape(C, D * D))


def p16_record(label, kernel: str, cfg: dict, err, fn, plain, library=None,
               iters: int = 3) -> dict:
    """A case's kernel and plain times, its bound (the registry's work) and
    the bytes its form moves (the registry's ``moved``) over the memory
    rate, and its library call's time where it has one."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels import registry
    b_ms, b_by = bound(kernel, **cfg)
    spec = registry.get(kernel)
    rec = dict(label=label, kernel=kernel, cfg=cfg, max_abs_err=err,
               ms=cuda_ms(fn, iters), plain_ms=cuda_ms(plain, 1),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=None if library is None else cuda_ms(library,
                                                               iters),
               moved_ms=spec.moved(spec.config(cfg)) / roofline.HW.hbm_bw
               * 1e3)
    lib = ("none" if library is None else f"{rec['library_ms']:.4f} ms")
    print(f"  {label}: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), its "
          f"form's bytes {rec['moved_ms']:.4f} ms, library {lib}")
    return rec


def p16_geometry() -> dict:
    """Each wrapper's geometry against the CUDA side's: gmm_loglik and
    bw_stats at every D from 1 to 720, gmm_rescore and gmm_align at every
    D from 1 to 512 for shapes on both sides of each old limit."""
    from repro_torch.kernels import bw_stats as BW
    from repro_torch.kernels import gmm_align as GA
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import gmm_rescore as GR

    def held(name, mine, theirs, shape):
        try:
            want = mine(*shape)
        except ValueError:
            want = None
        got = theirs(*shape)
        if want != got:
            fail(f"{name}: geometry{shape} is {want} in the wrapper, {got} "
                 f"in the kernel")
        return want is not None

    def loglik(D):
        g = GL.geometry(D)
        return g, GL.rows_positions(D) if g.wide else 0

    n = {"gmm_loglik": 0, "bw_stats": 0, "gmm_rescore": 0, "gmm_align": 0}
    for D in range(1, 721):
        n["gmm_loglik"] += held("gmm_loglik", loglik, GL.kernel_geometry,
                                (D,))
        n["bw_stats"] += held("bw_stats", BW.geometry, BW.kernel_geometry,
                              (D,))
    blocks = {BW.geometry(D).blocks for D in range(1, 513)}
    if blocks != {2}:
        fail(f"bw_stats: {sorted(blocks)} blocks an SM at D = 1..512, not "
             f"two at every D")
    for D in range(1, 513):
        for shape in ((1000, 20, 2048, D), (1000, 20, 58113, D),
                      (1000, 64, 65536, D)):
            n["gmm_rescore"] += held("gmm_rescore", GR.geometry,
                                     GR.kernel_geometry, shape)
        for shape in ((2048, D, 20), (2048, D, 40), (2048, D, 2048),
                      (6272, D, 40), (6273, D, 33), (8192, D, 8192),
                      (65536, D, 64), (2048, D, 20, True)):
            n["gmm_align"] += held("gmm_align", GA.geometry,
                                   GA.kernel_geometry, shape)
    held("gmm_rescore", GR.geometry, GR.kernel_geometry,
         (2 ** 31 // 20 + 1, 20, 2048, 72))
    print(f"  geometry equal on both sides: gmm_loglik and bw_stats at D = "
          f"1..720 ({n['gmm_loglik']} and {n['bw_stats']} fit; bw_stats "
          f"two blocks an SM at every D up to 512, by the CUDA occupancy "
          f"calculator), "
          f"gmm_rescore {n['gmm_rescore']} and gmm_align {n['gmm_align']} "
          f"shapes at D = 1..512; gmm_rescore refuses F*K >= 2**31 on both")
    return n


def p16_rows_launch(x, const, lin, Pf):
    """A call of gmm_loglik's rows kernel alone on an operand packed once
    (the C entry, as the wrapper calls it), for its time apart from the
    packing; it does not count as a launch of the wrapper."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import gmm_loglik as GL
    F, D = x.shape
    C = const.shape[0]
    W, cst = GL.pack_rows(const, lin, Pf), const.contiguous()
    out = torch.empty((F, C), device=x.device)
    lib = _build.load("gmm_loglik")

    def run():
        _build.check(lib.gmm_loglik_f32(
            x.data_ptr(), W.data_ptr(), cst.data_ptr(), out.data_ptr(), F,
            C, D, W.shape[1], W.shape[0], *_build.launch_args(x)),
            "gmm_loglik")
    return run


def p16_loglik(g, dev) -> list:
    """gmm_loglik at D = 205 .. 512 (the rows form, 3xTF32 on the tensor
    cores) against its plain version and the float64 value, two calls
    bitwise equal, with torch.addmm over the packed expansion as its
    library call; and D = 204, the last narrow D, once."""
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import ref
    recs = []
    C = 2048
    for D, F in ((204, 1024),) + P16_LOGLIK:
        const, lin, Pf = p16_precisions(C, D, g, dev)
        x = torch.randn(F, D, generator=g, device=dev)
        geo = GL.geometry(D)
        label = f"gmm_loglik D={D}"
        got = GL.gmm_loglik(x, const, lin, Pf)
        err = held_exact(f"{label} [{F}x{D}] x C={C} ({geo.bm}-frame blocks"
                         f"{', rows form' if geo.wide else ''}"
                         f")", got, ref.gmm_loglik(x, const, lin, Pf),
                         exact_loglik(x, const, lin, Pf))
        if not torch.equal(got, GL.gmm_loglik(x, const, lin, Pf)):
            fail(f"{label}: two calls are not bitwise equal")
        del got
        if D == 204:
            continue
        E2 = 1 + D + D * (D + 1) // 2
        xp = ref.expand_quadratic(x)[:, 1:].contiguous()
        wp = GL.packed_weights(const, lin, Pf)[1:E2, :C].contiguous()
        rec = p16_record(
            label, "gmm_loglik", dict(F=F, C=C, D=D), err,
            lambda: GL.gmm_loglik(x, const, lin, Pf),
            lambda: ref.gmm_loglik(x, const, lin, Pf),
            lambda: torch.addmm(const, xp, wp))
        # the packing kernel against its plain version (bitwise); of the
        # wrapper's time, packing the row runs and the kernel alone
        if not torch.equal(GL.pack_rows(const, lin, Pf),
                           GL.row_weights(const, lin, Pf)):
            fail(f"{label}: the packing kernel's operand is not its plain "
                 f"version's")
        rec["pack_ms"] = cuda_ms(lambda: GL.pack_rows(const, lin, Pf), 3)
        rec["plain_pack_ms"] = cuda_ms(
            lambda: GL.row_weights(const, lin, Pf), 3)
        rec["kernel_only_ms"] = cuda_ms(p16_rows_launch(x, const, lin, Pf),
                                        3)
        print(f"  {label}: of it, packing {rec['pack_ms']:.4f} ms (plain "
              f"row_weights {rec['plain_pack_ms']:.4f}, the same bits), the "
              f"rows kernel alone {rec['kernel_only_ms']:.4f} ms")
        recs.append(rec)
        del const, lin, Pf, xp, wp
        torch.cuda.empty_cache()
    return recs


def p16_gamma(F: int, C: int, K: int, g, dev):
    """A top-K-like posterior [F, C]: K random components a frame with
    random weights summing to one."""
    idx = torch.randint(0, C, (F, K), generator=g, device=dev)
    w = torch.rand(F, K, generator=g, device=dev)
    gamma = torch.zeros(F, C, device=dev)
    gamma.scatter_add_(1, idx, w / w.sum(1, keepdim=True))
    return gamma


def p16_bw(g, dev) -> list:
    """bw_stats at D = 255, 256 and 512 (the pairs form) against its plain
    version on a top-20-like Γ, two calls bitwise equal, with
    torch.matmul(Γᵀ, X₂) over the packed width as its library call; the
    touched bound over the form's component tiles."""
    from repro_torch.kernels import bw_stats as BW
    from repro_torch.kernels import ref
    recs = []
    C = 2048
    for D, F in P16_BW:
        x = torch.randn(F, D, generator=g, device=dev)
        gamma = p16_gamma(F, C, 20, g, dev)
        label = f"bw_stats D={D}"
        geo = BW.geometry(D)
        got = BW.bw_stats(gamma, x)
        err = max(compare(f"{label} {nm} [{F}x{C}]ᵀ [{F}x{D}] "
                          f"({'pairs' if geo.pairs else 'rows'} form)", a, w)
                  for nm, a, w in zip("nfS", got, ref.bw_stats(gamma, x)))
        if not all(torch.equal(a, b)
                   for a, b in zip(got, BW.bw_stats(gamma, x))):
            fail(f"{label}: two calls are not bitwise equal")
        del got
        touched = (gamma != 0).reshape(F, C // geo.tile, geo.tile).any(2) \
            .float().mean().item()
        i0, i1, _ = ref._quad_pairs(D, dev)
        x2p = torch.cat([x[:, i0] * x[:, i1], x, torch.ones_like(x[:, :1])],
                        1)
        gT = gamma.T
        # the bound and the bytes over the (frame, tile) pairs this Γ
        # touches, the work the kernel's frame lists leave it
        rec = p16_record(label, "bw_stats",
                         dict(F=F, C=C, D=D, touched=touched), err,
                         lambda: BW.bw_stats(gamma, x),
                         lambda: ref.bw_stats(gamma, x),
                         lambda: torch.matmul(gT, x2p))
        rec["touched"] = touched
        rec["dense_bound_ms"] = bound("bw_stats", F=F, C=C, D=D)[0]
        print(f"  {label}: (frame, {geo.tile}-component tile) pairs touched "
              f"{touched:.4f}; the dense work's bound "
              f"{rec['dense_bound_ms']:.4f} ms; bitwise repeatable")
        recs.append(rec)
        del x2p, gT, gamma
        torch.cuda.empty_cache()
    return recs


def p16_rescore(g, dev) -> list:
    """gmm_rescore with P in strips (D = 201, 256, 512) and with its sort's
    counts in device memory (C = 65,536) against its plain version, two
    calls bitwise equal; no library call computes it."""
    from repro_torch.kernels import gmm_rescore as GR
    from repro_torch.kernels import ref
    recs = []
    K = 20
    for D, C, F in P16_RESCORE:
        Cs = min(C, 2048)       # C = 65,536: 2,048 precisions dealt out
        const, lin, Pf = p16_precisions(Cs, D, g, dev)
        if C > Cs:
            rep = torch.arange(C, device=dev) % Cs
            const = (const[rep] + torch.randn(C, generator=g, device=dev))
            lin, Pf = lin[:, rep].contiguous(), Pf[rep]
        A = ref.rescore_pack(const, lin, Pf)
        x = torch.randn(F, D, generator=g, device=dev)
        sel = torch.randint(0, C, (F, K), generator=g, device=dev)
        geo = GR.geometry(F, K, C, D)
        label = f"gmm_rescore D={D} C={C}"
        got = GR.gmm_rescore(x, sel, A)
        err = held_exact(f"{label} [{F}x{K}] (P in rows of {geo.strip}, "
                         f"the sort's counts in "
                         f"{'device' if geo.hist_global else 'shared'} "
                         f"memory)", got,
                         ref.gmm_rescore(x, sel, const, lin, Pf),
                         exact_rescore(x, sel, A))
        if not torch.equal(got, GR.gmm_rescore(x, sel, A)):
            fail(f"{label}: two calls are not bitwise equal")
        recs.append(p16_record(
            label, "gmm_rescore", dict(F=F, K=K, C=C, D=D,
                                       rows_touched=torch.unique(sel)
                                       .numel()), err,
            lambda: GR.gmm_rescore(x, sel, A),
            lambda: ref.gmm_rescore(x, sel, const, lin, Pf)))
        del const, lin, Pf, A, got
        torch.cuda.empty_cache()
    print("  gmm_rescore: two calls bitwise equal at every shape")
    return recs


def p16_diag(C: int, D: int, g, dev):
    """A random diagonal GMM's preselect coefficients (dconst [C], dlin,
    dquad [D, C]) and its means and deviations, to draw frames from."""
    from repro_torch.core import ubm as U
    w = torch.rand(C, generator=g, device=dev) + 0.5
    means = torch.randn(C, D, generator=g, device=dev)
    var = torch.rand(C, D, generator=g, device=dev) + 0.5
    coeffs = tuple(t.contiguous() for t in
                   U.diag_coeffs(U.DiagGMM(w / w.sum(), means, var)))
    return coeffs, means, var.sqrt()


def held_select_order(label, x, dconst, dlin, dquad, A2, K, sel) -> None:
    """The spill form's selection held in its order, on every frame: the
    kernel run again with a scratch of the caller's, whose first F x Cp
    words then hold the preselect's scores. Those are held to TOL of the
    plain diagonal scores, and the select must give, slot by slot, what a
    stable descending sort of them gives (best first, ties to the lowest
    id, -0 as +0; a slot past the scores above -inf takes id 0), and the
    same as the first run. For frames with no NaN."""
    from repro_torch.kernels import gmm_align as GA
    F, C = x.shape[0], dconst.shape[0]
    Cp = -(-C // GA.NC) * GA.NC
    scratch = torch.empty(GA.spill_words(F, C, K), dtype=torch.int32,
                          device=x.device)
    _, sel2 = GA.gmm_align(x, dconst, dlin, dquad, A2, K, scratch=scratch)
    scores = scratch[:F * Cp].view(torch.float32).view(F, Cp)[:, :C]
    plain = dconst[None] + x @ dlin + (x * x) @ dquad
    fin = torch.isfinite(plain)
    compare(f"gmm_align {label} preselect scores", scores[fin], plain[fin])
    if not torch.equal(scores[~fin], plain[~fin]):
        fail(f"gmm_align {label}: the preselect's -inf scores differ")
    best = torch.sort(scores, dim=1, descending=True, stable=True)
    want = torch.where(best.values[:, :K] == float("-inf"), 0,
                       best.indices[:, :K])
    same = (sel2 == want).all(dim=1)
    print(f"  gmm_align {label}: the select's order equals a stable sort of "
          f"its scores on {same.sum().item()} of {F} frames (all required)")
    if not same.all():
        fail(f"gmm_align {label}: the select orders its K otherwise")
    if not torch.equal(sel2, sel):
        fail(f"gmm_align {label}: two runs select differently")


def p16_align(g, dev) -> list:
    """gmm_align's spill form (K > 32 past the whole-row blocks: C = 6273,
    8192 and 65,536 at K = 33, 64 and C) and wide phase B (D = 235, 256,
    512 at C = 2048, K = 20) against the plain preselect + packed rescore
    (``held_align``: the selected sets, the share that agrees printed;
    the spill form's order too, ``held_select_order``); the spill form's
    NaN rule and zero-weight components against
    ``ref.argmax_topk``; the spill form's device time by launch."""
    from repro_torch.kernels import gmm_align as GA
    from repro_torch.kernels import ref
    recs = []
    cases = ([(72, C, K, F) for C, K, F in P16_ALIGN_C]
             + [(D, 2048, 20, F) for D, F in P16_ALIGN_D])
    for D, C, K, F in cases:
        (dconst, dlin, dquad), mu, sd = p16_diag(C, D, g, dev)
        const, lin, Pf = p16_precisions(min(C, 2048), D, g, dev)
        if C > 2048:
            rep = torch.arange(C, device=dev) % 2048
            const, lin, Pf = const[rep], lin[:, rep], Pf[rep]
        A2 = ref.align_pack(const, lin, Pf)
        del const, lin, Pf
        comp = torch.randint(0, C, (F,), generator=g, device=dev)
        x = mu[comp] + sd[comp] * torch.randn(F, D, generator=g, device=dev)
        geo = GA.geometry(C, D, K)
        label = f"gmm_align D={D} C={C} K={K}"
        form = "spill" if geo.spill else "stream" if geo.stream else "rows"
        err, sel = held_align(f"D={D} C={C} K={K} [{F}x{D}] ({form}"
                              f"{', wide phase B' if geo.wide else ''})",
                              x, dconst, dlin, dquad, A2, K,
                              exact=geo.wide)
        if geo.spill:
            held_select_order(f"D={D} C={C} K={K} [{F}x{D}]", x, dconst,
                              dlin, dquad, A2, K, sel)
        rec = p16_record(label, "gmm_align",
                         dict(F=F, C=C, D=D, K=K,
                              rows_touched=torch.unique(sel).numel()), err,
                         lambda: GA.gmm_align(x, dconst, dlin, dquad, A2, K),
                         lambda: ref.gmm_align(x, dconst, dlin, dquad, A2, K),
                         iters=2)
        rec["form"] = form
        if label == P16_ROWS["gmm_align_spill"]:
            prof = profile_path(lambda: GA.gmm_align(x, dconst, dlin, dquad,
                                                     A2, K))
            rec["by_launch"] = prof["top"]
            print(f"  {label}, device ms by launch: "
                  + "; ".join(f"{short_name(n)} {ms:.4f}"
                              for n, ms, _ in prof["top"][:4]))
        if geo.spill and K == 64 and C == 8192:
            # the NaN rule and zero-weight components, as phase 3 holds
            # the streaming and whole-row instances
            xn = x[:1000].clone()
            xn[3] = float("nan")
            dn = dconst.clone()
            dn[C - 1] = float("nan")
            _, seln = held_align(f"D={D} C={C} K={K} NaN rule", xn, dn, dlin, dquad,
                                 A2, K, ref.argmax_topk(ref.diag_topk(
                                     xn, dn, dlin, dquad, K)[0], K))
            if not ((seln[3] == C - 1).all() and (seln[:, 0] == C - 1)
                    .all()):
                fail("gmm_align's spill form breaks the NaN rule")
            finite = torch.arange(5, C, 150, device=dev)
            dz = torch.full_like(dconst, float("-inf"))
            dz[finite] = dconst[finite]
            _, selz = held_align(f"D={D} C={C} K={K} zero-weight components",
                                 x[:1000].contiguous(), dz, dlin, dquad, A2,
                                 K, ref.argmax_topk(ref.diag_topk(
                                     x[:1000], dz, dlin, dquad, K)[0], K))
            if not (selz[:, finite.numel():] == 0).all():
                fail("gmm_align's spill form breaks the -inf rule")
            held_select_order(f"D={D} C={C} K={K} zero-weight components",
                              x[:1000].contiguous(), dz, dlin, dquad, A2, K,
                              selz)
        recs.append(rec)
        del A2, x, sel
        torch.cuda.empty_cache()
    return recs


def p16_synthetic(cfg, seed: int, dev):
    """The D = 256 system and corpus: a random full-covariance UBM and TVM
    (``synthetic_system``), P16_UTTS x P16_FRAMES frames drawn from it with
    every component dealt an equal share, then the frames and the UBM moved
    by one affine map that gives the frames zero mean and unit variance a
    dimension (the normalisation that keeps the M-step's Σ definite; the
    UBM still describes the frames exactly)."""
    from repro_torch.core import tvm as TV
    from repro_torch.core import ubm as U
    ubm, _, g = synthetic_system(cfg, seed, dev)
    feats = synthetic_corpus(ubm, P16_UTTS, P16_FRAMES, g,
                             every_component=True)
    flat = feats.reshape(-1, feats.shape[-1])
    mu, sd = flat.mean(0), flat.std(0)
    feats = (feats - mu) / sd
    ubm = U.FullGMM(ubm.weights, (ubm.means - mu) / sd,
                    ubm.covs / (sd[:, None] * sd[None, :]))
    model = TV.init_model(g, ubm.means, ubm.covs, cfg.ivector_dim,
                          cfg.formulation, prior_offset=cfg.prior_offset)
    return ubm, model, feats, g


def p16_rung_stats(cfg, ubm, feats, dev) -> dict:
    """The three rungs' statistics of the same 32 utterances with no
    posterior floor (``engine.chunk_body``: alignment, then n, f and the
    full S through bw_stats): the sparse and fused rungs against the dense
    one, each of n, f and S within RUNG_TOL x its max|value| (phase 10's
    limit). -> (readings, launches by rung)."""
    from repro_torch.core import engine as EN
    pack = EN.pack_ubm(ubm, dev)
    stats, launches = {}, {}
    for rung in ("dense", "sparse", "fused"):
        spec = EN.EngineSpec(n_components=cfg.n_components,
                             top_k=cfg.posterior_top_k, floor=0.0,
                             second_order="full", rescore=rung)
        reset_counts()
        cs = EN.chunk_body(spec, pack, feats[:32])
        _sync(dev)
        launches[rung] = read_counts()
        stats[rung] = (cs.n, cs.f, cs.S)
    read = {}
    for rung in ("sparse", "fused"):
        read[rung] = max(rel_err(a, w) for a, w in
                         zip(stats[rung], stats["dense"]))
        print(f"  D={P16_D} rungs: {rung} against dense, n, f and S of 32 "
              f"utterances, no floor: {read[rung]:.3e} x max|value| "
              f"(tolerance {RUNG_TOL})")
        if read[rung] > RUNG_TOL:
            fail(f"D={P16_D}: the {rung} rung disagrees with the dense one")
    return read, launches


def f64_ivectors(model, n, f):
    """``tvm.extract_ivectors`` in float64 on the float64 model: the
    posterior's solve on L = I + sum_c n_c T_c' S_c^-1 T_c. Statistics
    raw (augmented) or centred (standard), as the session hands them ->
    (i-vectors [u, R] centred at the prior, not length-normalised; |phi|
    [u]; the condition number of L [u])."""
    T, S = model.T.double(), model.Sigma.double()
    Pj = torch.cholesky_solve(T, torch.linalg.cholesky(S))
    U = T.transpose(1, 2) @ Pj
    U = 0.5 * (U + U.transpose(1, 2))
    u, C, D = f.shape
    R = T.shape[2]
    prior = model.prior.double()
    L = torch.eye(R, dtype=torch.float64, device=n.device) + torch.einsum(
        "uc,crs->urs", n.double(), U)
    del U
    phi = torch.linalg.solve(L, prior[None] + f.reshape(u, C * D).double()
                             @ Pj.reshape(C * D, R))
    ev = torch.linalg.eigvalsh(L)
    return phi - prior[None], phi.norm(dim=1), ev[:, -1] / ev[:, 0]


def p16_conditioning(label: str, cfg, model, ubm, reqs, served,
                     dev) -> dict:
    """What the rungs' served i-vectors of a trained model (``served``: rung
    -> [N, R], unit length) differ by, taken apart. The requests'
    statistics on each rung (``engine.chunk_body`` on one padded batch, the
    session's floor), and from them:

      * the float64 extraction (``f64_ivectors``): the i-vectors the rungs'
        statistics decide. Held: the rungs within IVEC_TOL of each other.
      * the plain f32 extraction (``tvm.precompute`` 'dense' and its
        Cholesky solve; no kernel) against float64: e_plain, the largest
        over the rungs, the f32 solve's own error on this model.
      * the session's f32 extraction (packed E-step kernel) of the same
        statistics against float64, and the served rungs' gap: each held
        to IVEC_TOL + 2 e_plain (a gap is two f32 solves of one system
        apart, each off by e_plain's order; where that is far below
        IVEC_TOL, the solves' own forms differ by more than their ratio).

    All on unit i-vectors; |phi|, |phi - prior| and the condition number
    of L printed. -> readings."""
    from dataclasses import replace
    from repro_torch.core import engine as EN
    from repro_torch.core import stats as ST
    from repro_torch.core import tvm as TV
    from repro_torch.serving import IVectorExtractor, ServingConfig

    def unit(v):
        v = v.double()
        return v / v.norm(dim=-1, keepdim=True)

    D = cfg.feat_dim
    frames = max(r.shape[0] for r in reqs)
    x = torch.zeros(len(reqs), frames, D, device=dev)
    m = torch.zeros(len(reqs), frames, device=dev)
    for i, r in enumerate(reqs):
        x[i, :r.shape[0]] = torch.from_numpy(r).to(dev)
        m[i, :r.shape[0]] = 1
    pre_plain = TV.precompute(model, estep="dense", device=dev)
    iv64, e_plain, e_kernel = {}, 0.0, 0.0
    for rung in ("sparse", "dense", "fused"):
        ex = IVectorExtractor(cfg.with_overrides(rescore=rung), model, ubm,
                              ServingConfig(), device=dev)
        cs = EN.chunk_body(replace(ex._spec, rescore=rung), ex._pack, x, m)
        n, f = cs.n, cs.f
        if model.formulation == "standard":
            stc = ST.center(ST.BWStats(n, f, None), model.means)
            n, f = stc.n, stc.f
        iv64[rung], phi_norm, kappa = f64_ivectors(model, n, f)
        want = unit(iv64[rung])
        e_plain = max(e_plain, float((unit(TV.extract_ivectors(
            model, pre_plain, n, f)) - want).abs().max()))
        e_kernel = max(e_kernel, float((unit(TV.extract_ivectors(
            model, ex._tv_pre, n, f, estep_dtype=cfg.estep_dtype))
            - want).abs().max()))
        del ex, cs, n, f
    del pre_plain
    torch.cuda.empty_cache()
    rec = {"e_plain": e_plain, "e_kernel": e_kernel,
           "kappa": [float(kappa.min()), float(kappa.max())],
           "phi_norm": [float(phi_norm.min()), float(phi_norm.max())],
           "ivec_norm": [float(iv64["dense"].norm(dim=1).min()),
                         float(iv64["dense"].norm(dim=1).max())]}
    limit = IVEC_TOL + 2 * e_plain
    print(f"  {label}: L's condition number {rec['kappa'][0]:.3e} to "
          f"{rec['kappa'][1]:.3e}; |phi| {rec['phi_norm'][0]:.1f} to "
          f"{rec['phi_norm'][1]:.1f} against |phi - prior| "
          f"{rec['ivec_norm'][0]:.2f} to {rec['ivec_norm'][1]:.2f}; the "
          f"plain f32 extraction from float64 {e_plain:.3e}, the session's "
          f"{e_kernel:.3e} (tolerance {IVEC_TOL} + 2 x {e_plain:.3e} = "
          f"{limit:.3e})")
    if e_kernel > limit:
        fail(f"{label}: the session's extraction is further from float64 "
             "than f32 rounding on this model explains")
    for rung in ("dense", "fused"):
        d64 = float((unit(iv64[rung]) - unit(iv64["sparse"])).abs().max())
        gap = float(np.abs(served[rung] - served["sparse"]).max())
        rel = gap / float(np.abs(served["sparse"]).max())
        rec[f"f64_sparse_vs_{rung}"] = d64
        rec[f"served_sparse_vs_{rung}"] = gap
        print(f"  {label}, sparse vs {rung}: the float64 extractions of "
              f"the rungs' statistics {d64:.3e} (tolerance {IVEC_TOL}); "
              f"served {gap:.3e}, {rel:.3e} x max|i-vector| (tolerance "
              f"{limit:.3e})")
        if d64 > IVEC_TOL:
            fail(f"{label}: the {rung} rung's statistics decide other "
                 "i-vectors than the sparse rung's")
        if gap > limit:
            fail(f"{label}: the sparse and {rung} rungs serve i-vectors "
                 "further apart than f32 rounding on this model explains")
    return rec


def p16_trained_d72(seed: int, dev) -> dict:
    """The D = 256 run's trained-model check at the paper's D = 72 (the
    forms before phase 16's): the same corpus size, 2 EM iterations, the
    same requests served on each rung, ``p16_conditioning``."""
    from repro_torch.configs.ivector_tvm import CONFIG
    from repro_torch.core import trainer as TR
    from repro_torch.serving import IVectorExtractor, ServingConfig
    cfg = CONFIG
    ubm, _, feats, _ = p16_synthetic(cfg, seed, dev)
    state = TR.train(cfg, ubm, feats, n_iters=2,
                     generator=torch.Generator().manual_seed(seed),
                     device=dev)
    reqs = [feats[i % P16_UTTS, :256 + 8 * i].cpu().numpy()
            for i in range(P16_REQUESTS)]
    served = {rung: IVectorExtractor(cfg.with_overrides(rescore=rung),
                                     state.model, ubm, ServingConfig(),
                                     device=dev).extract(reqs)
              for rung in ("sparse", "dense", "fused")}
    rec = p16_conditioning(f"D={cfg.feat_dim} trained model", cfg,
                           state.model, ubm, reqs, served, dev)
    del state, ubm, feats
    torch.cuda.empty_cache()
    return rec


def p16_vs_cpu(cfg, seed: int, dev) -> dict:
    """The D = 256 path at C = P16_CPU_C on the card and on the CPU's
    plain versions: the statistics pass (fused rung; n and f) and the
    i-vectors of four requests served on the sparse and fused rungs, each
    within IVEC_TOL x max|value| with no posterior floor; at the config's
    floor the same readings are printed, not held (a posterior the two
    sides round across the floor drops out on one side only). Then the
    model of 2 EM iterations on the card (the whole corpus) serves the
    same requests on both sides, held alike with no floor."""
    from repro_torch.core import trainer as TR
    from repro_torch.serving import IVectorExtractor, ServingConfig
    cfg_c = cfg.with_overrides(n_components=P16_CPU_C, rescore="fused")
    ubm, model, corpus, g = p16_synthetic(cfg_c, seed + 2, dev)
    cpu = torch.device("cpu")
    feats = corpus[:16, :256].contiguous()
    reqs = [feats[i, :200 + 16 * i].cpu().numpy() for i in range(4)]
    sides = (("card", dev), ("cpu", cpu))
    out = {}
    for floor in (cfg.posterior_floor, 0.0):
        c0 = cfg_c.with_overrides(posterior_floor=floor)
        st = {w: TR.stats_ll(c0, ubm.to(d), feats.to(d))[0]
              for w, d in sides}
        read = {k: rel_err(getattr(st["card"], k).cpu(),
                           getattr(st["cpu"], k)) for k in ("n", "f")}
        for rung in ("sparse", "fused"):
            c = c0.with_overrides(rescore=rung)
            iv = {w: IVectorExtractor(c, model.to(d), ubm.to(d),
                                      ServingConfig(max_batch=4),
                                      device=d).extract(reqs)
                  for w, d in sides}
            read[f"ivectors_{rung}"] = float(
                np.abs(iv["card"] - iv["cpu"]).max()
                / np.abs(iv["cpu"]).max())
        held = floor == 0.0
        for k, v in read.items():
            print(f"  D={P16_D} C={P16_CPU_C} card vs CPU plain path, floor "
                  f"{floor}, {k}: {v:.3e} x max|value| "
                  f"({f'tolerance {IVEC_TOL}' if held else 'not held'})")
            if held and v > IVEC_TOL:
                fail(f"D={P16_D}: card and CPU disagree on {k}")
        out[f"floor{floor}"] = read
    trained = TR.train(cfg_c, ubm, corpus, n_iters=2,
                       generator=torch.Generator().manual_seed(seed),
                       device=dev).model
    c0 = cfg_c.with_overrides(posterior_floor=0.0)
    for rung in ("sparse", "fused"):
        iv = {w: IVectorExtractor(c0.with_overrides(rescore=rung),
                                  trained.to(d), ubm.to(d),
                                  ServingConfig(max_batch=4),
                                  device=d).extract(reqs)
              for w, d in sides}
        v = float(np.abs(iv["card"] - iv["cpu"]).max()
                  / np.abs(iv["cpu"]).max())
        out[f"trained_ivectors_{rung}"] = v
        print(f"  D={P16_D} C={P16_CPU_C} trained model (2 EM iterations) "
              f"card vs CPU plain path, floor 0.0, ivectors_{rung}: "
              f"{v:.3e} x max|value| (tolerance {IVEC_TOL})")
        if v > IVEC_TOL:
            fail(f"D={P16_D}: card and CPU serve the trained model's "
                 f"i-vectors apart on the {rung} rung")
    return out


def p16_path(seed: int, dev):
    """The i-vector main path at D = 256, C = 2048, R = 400, K = 20:
    train_ubm (1 diagonal + 1 full iteration, dense rung), the three rungs'
    statistics, the statistics pass, 2 TVM EM iterations (twice: bitwise
    equal), extraction, P16_REQUESTS requests served on the sparse, dense
    and fused rungs (the trained model's gap taken apart and held by
    ``p16_conditioning``, and the same at D = 72); then card against CPU at
    C = 64. -> (record, launches by run)."""
    from repro_torch.configs.ivector_tvm import CONFIG
    from repro_torch.core import trainer as TR
    from repro_torch.core import ubm as U
    from repro_torch.serving import IVectorExtractor, ServingConfig
    cfg = CONFIG.with_overrides(feat_dim=P16_D)
    rec, paths = {}, {}
    t0 = time.perf_counter()
    ubm, model, feats, g = p16_synthetic(cfg, seed, dev)
    C, D = ubm.means.shape
    rec["setup_s"] = time.perf_counter() - t0
    print(f"  D={D} C={C} R={cfg.ivector_dim} K={cfg.posterior_top_k}: "
          f"{P16_UTTS} utterances x {P16_FRAMES} frames drawn and "
          f"normalised in {rec['setup_s']:.1f} s")

    reset_counts()
    t0 = time.perf_counter()
    ubm_t = U.train_ubm(feats.reshape(-1, D), C,
                        torch.Generator(device=dev).manual_seed(seed),
                        diag_iters=1, full_iters=1,
                        top_k=cfg.posterior_top_k, device=dev)
    _sync(dev)
    rec["train_ubm_s"] = time.perf_counter() - t0
    paths["d256_train_ubm"] = read_counts()
    check_finite("D=256 train_ubm", ubm_t.weights, ubm_t.means, ubm_t.covs)
    require_launches("D=256 train_ubm", paths["d256_train_ubm"],
                     ("gmm_loglik_wide", "bw_stats", "bw_stats_pairs"))
    del ubm_t
    print(f"  train_ubm (1 diag + 1 full iteration, top-20, dense rung): "
          f"{rec['train_ubm_s']:.2f} s")

    rec["rungs"], rung_paths = p16_rung_stats(cfg, ubm, feats, dev)
    for rung, c in rung_paths.items():
        paths[f"d256_rung_{rung}"] = c
    require_launches("D=256 rungs", {
        k: sum(c[k] for c in rung_paths.values()) for k in
        ("gmm_loglik_wide", "gmm_rescore_strips", "gmm_align_wide",
         "bw_stats", "bw_stats_pairs")}, ("gmm_loglik_wide",
                                          "gmm_rescore_strips",
                                          "gmm_align_wide", "bw_stats",
                                          "bw_stats_pairs"))

    reset_counts()
    t0 = time.perf_counter()
    st, _ = TR.stats_ll(cfg, ubm, feats)
    _sync(dev)
    rec["stats_pass_s"] = time.perf_counter() - t0
    paths["d256_stats"] = read_counts()
    del st
    state, secs, diags, paths["d256_train"] = timed_train(cfg, ubm, feats, 2,
                                                          seed, dev)
    require_launches("D=256 train", paths["d256_train"],
                     ("gmm_rescore_strips", "bw_stats", "bw_stats_pairs",
                      "tvm_estep_l_train", "tvm_estep_a"))
    again = TR.train(cfg, ubm, feats, n_iters=2,
                     generator=torch.Generator().manual_seed(seed),
                     device=dev)
    for a, b in ((state.model.T, again.model.T),
                 (state.model.Sigma, again.model.Sigma),
                 (state.model.prior, again.model.prior)):
        if not torch.equal(a, b):
            fail("D=256: two EM runs from the same state are not bitwise "
                 "equal")
    del again
    rec.update(train_iter_s=secs, train_diag=diags)
    print(f"  statistics pass {rec['stats_pass_s']:.2f} s; 2 EM iterations "
          f"{', '.join(f'{t:.2f}' for t in secs)} s, repeated bitwise")

    reset_counts()
    t0 = time.perf_counter()
    iv = TR.extract(cfg, state, feats, device=dev)
    _sync(dev)
    rec["extract_s"] = time.perf_counter() - t0
    paths["d256_extract"] = read_counts()
    check_finite("D=256 extract", iv)
    if iv.shape != (P16_UTTS, cfg.ivector_dim):
        fail(f"D=256 extract: shape {tuple(iv.shape)}")
    del iv
    # served on each rung: with the trained model at the config's floor,
    # whose rungs' gap p16_conditioning takes apart and holds (its L is
    # conditioned far worse than the drawn model's: the f32 solve's own
    # error sets the gap), then with the drawn model as phase 4 serves,
    # with no floor (a posterior the rungs round across a floor drops out
    # on one rung only), held to IVEC_TOL of each other
    reqs = [feats[i % P16_UTTS, :256 + 8 * i].cpu().numpy()
            for i in range(P16_REQUESTS)]
    for which, mdl, floor, held in (
            ("trained", state.model, cfg.posterior_floor, False),
            ("drawn", model, 0.0, True)):
        served = {}
        for rung in ("sparse", "dense", "fused"):
            ex = IVectorExtractor(cfg.with_overrides(
                rescore=rung, posterior_floor=floor), mdl, ubm,
                ServingConfig(), device=dev)
            tag = f"d256_serve_{which}_{rung}"
            served[rung], paths[tag], rec[tag + "_s"] = drive(
                ex, reqs, f"D={D} served, {which} model, {rung} rung, "
                f"floor {floor}")
            check_ivectors(served[rung], len(reqs), cfg.ivector_dim,
                           f"D={D} {rung}")
            del ex
        for rung in ("dense", "fused"):
            d = float(np.abs(served[rung] - served["sparse"]).max())
            rec[f"serve_{which}_sparse_vs_{rung}"] = d
            print(f"  D={D} served, {which} model, floor {floor}, sparse vs "
                  f"{rung}: max |diff| {d:.3e} "
                  f"({f'tolerance {IVEC_TOL}' if held else 'held below'})")
            if held and d > IVEC_TOL:
                fail(f"D={D}: the sparse and {rung} rungs serve other "
                     "i-vectors")
        if which == "trained":
            rec["conditioning"] = p16_conditioning(
                f"D={D} trained model", cfg, state.model, ubm, reqs, served,
                dev)
    del state, ubm, model, feats
    torch.cuda.empty_cache()
    rec["conditioning_d72"] = p16_trained_d72(seed, dev)
    rec["vs_cpu"] = p16_vs_cpu(cfg, seed, dev)
    return rec, paths


def p16_spill_train(seed: int, dev):
    """train_ubm at C = 8192, D = 72 with the reference's default
    top_k=0 (K = C), fused rung: one diagonal and one full iteration on
    P16_SPILL_UTTS x 512 frames drawn from the phase-3 system, normalised;
    the spill form must launch. -> (record, launches)."""
    from repro_torch.configs.ivector_tvm import CONFIG
    from repro_torch.core import ubm as U
    ubm, _, g = synthetic_system(CONFIG, seed, dev)
    x = synthetic_corpus(ubm, P16_SPILL_UTTS, 512, g).reshape(
        -1, CONFIG.feat_dim)
    x = (x - x.mean(0)) / x.std(0)
    del ubm
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = U.train_ubm(x, P16_SPILL_C,
                      torch.Generator(device=dev).manual_seed(seed),
                      diag_iters=1, full_iters=1, top_k=0, rescore="fused",
                      device=dev)
    _sync(dev)
    rec = {"seconds": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "frames": x.shape[0]}
    launches = read_counts()
    check_finite("train_ubm C=8192 top_k=0", out.weights, out.means,
                 out.covs)
    require_launches("train_ubm C=8192 top_k=0", launches,
                     ("gmm_align_spill", "bw_stats"))
    print(f"  train_ubm C={P16_SPILL_C} D={CONFIG.feat_dim} top_k=0 (K = "
          f"C), fused, 1 diag + 1 full iteration on {x.shape[0]} frames: "
          f"{rec['seconds']:.2f} s, peak {rec['peak_gb']:.1f} GB; spill "
          f"launches {launches['gmm_align_spill']}")
    del out, x
    torch.cuda.empty_cache()
    return rec, launches


def shapes_phase(seed: int, dev):
    """Phase 16: the i-vector kernels' new forms, then the main-path runs
    that take them. -> (kernel rows, launches by run, record)."""
    rec = {}
    g = torch.Generator(device=dev).manual_seed(seed + 16)
    t0 = time.perf_counter()
    rec["geometry"] = p16_geometry()
    cases = (p16_loglik(g, dev) + p16_bw(g, dev) + p16_rescore(g, dev)
             + p16_align(g, dev))
    rec["cases"] = cases
    rec["kernels_s"] = time.perf_counter() - t0
    paths = {}
    rec["d256"], d256_paths = p16_path(seed, dev)
    paths.update(d256_paths)
    rec["spill_train_ubm"], paths["spill_train_ubm"] = p16_spill_train(
        seed, dev)
    by_label = {c["label"]: c for c in cases}
    sources = {"gmm_loglik": "gmm_loglik", "bw_stats": "bw_stats",
               "gmm_rescore": "gmm_rescore", "gmm_align": "gmm_align"}
    rows = []
    for name, label in P16_ROWS.items():
        c = by_label[label]
        base = c["kernel"]
        rows.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{sources[base]}.cu",
            replaces=REPLACES[base], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            moved_ms=c["moved_ms"], shape=c["cfg"]))
    torch.cuda.empty_cache()
    return rows, paths, rec


def phase_16_alone(args, card: str, kind: str, build_s: float) -> int:
    """``--phase 16``: phase 16 alone after the card and build steps, its
    kernel rows' launches from its own main-path runs; writes
    chiprun_out/chip_smoke_phase16.json and prints the kernels line of its
    rows, the card and the contract line."""
    dev = torch.device("cuda")
    print(f"[16] the i-vector kernels' shape range ({card})")
    t0 = time.perf_counter()
    rows, paths, rec = shapes_phase(args.seed, dev)
    rec["phase_s"] = time.perf_counter() - t0
    print(f"  phase 16 {rec['phase_s']:.1f} s")
    for r in rows:
        r["launches"] = sum(p.get(r["name"], 0) for p in paths.values())
        r["on_path"] = r["name"] not in OFF_PATH
        if r["on_path"] and r["launches"] == 0:
            fail(f"no main-path run launched {r['name']}")
    record = {"card": card, "build_s": build_s, "launches": paths,
              "shapes": rec, "kernels": rows,
              "command_s": time.perf_counter() - T_START}
    print(f"chip_smoke: {record['command_s']:.1f} s from start")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_phase16.json").write_text(
        json.dumps(record, indent=1, default=str))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "on_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# Phase 17: the LM kernels' whole domain, head dims 1 to 512 in f32 and bf16
# and d_states 1 to 256 at every scan_dtype, forward and backward. The
# attention's cases at a ragged S under GQA, each head dim in both types
# (bf16 on each tensor-core form: tc, tc8, staged, wide); the scan's at ragged T and di, with h0 and dh_last and
# several backward segments; then the timed shapes: the forward at a Jamba
# prefill's (B 4, T 2048, di 8192), the backward at a micro-batch's (B 1,
# T 4096)
P17_HEAD_DIMS = (1, 8, 24, 33, 40, 72, 100, 136, 144, 160, 176, 200, 257,
                 320, 384, 448, 512)
P17_ATT = dict(B=2, S=1000, H=8, KVH=2)
# phase 17's f32 main-path runs (smoke_train_vs_cpu): a train step card vs
# CPU on the CUDA-core kernels past 256 (two gradient column slices) and
# at a head dim staged 4 wide
P17_F32_SMOKE = (
    ("stablelm-1.6b f32 head_dim 320", "stablelm-1.6b", {"head_dim": 320}),
    ("whisper-large-v3 f32 head_dim 33", "whisper-large-v3",
     {"head_dim": 33}))
# rows a tile of backward_blocks, the backward's plain version, on the card
P17_PLAIN_BLOCK = 250
P17_D_STATES = (65, 100, 128, 129, 200, 256)
P17_SCAN = dict(B=2, T=600, di=520)
P17_SCAN_FWD = dict(B=4, T=2048, di=8192)
P17_SCAN_BWD = dict(B=1, T=4096, di=8192)
P17_TIMED_D_STATES = (128, 256)
# the d_state of the scan's kernel rows, at which the plain versions are
# timed (once each, host clock)
P17_ROW_D_STATE = 128
# the kernels line's rows of the new forms -> the case whose numbers each
# takes: (kind, dtype or scan_dtype, head dim or d_state)
P17_ROWS = {
    "flash_attention_tc8": ("fwd", "bfloat16", 72),
    "flash_attention_staged": ("fwd", "bfloat16", 100),
    "flash_attention_wide": ("fwd", "bfloat16", 320),
    "flash_attention_bwd_tc8": ("bwd", "bfloat16", 72),
    "flash_attention_bwd_staged": ("bwd", "bfloat16", 100),
    "flash_attention_bwd_wide": ("bwd", "bfloat16", 320),
    "flash_attention_simt": ("fwd", "float32", 320),
    "flash_attention_bwd_simt": ("bwd", "float32", 320),
    "selective_scan_grouped": ("scan", "float32", P17_ROW_D_STATE),
    "selective_scan_grouped_bf16": ("scan", "bfloat16", P17_ROW_D_STATE),
    "selective_scan_grouped_f16": ("scan", "float16", P17_ROW_D_STATE),
    "selective_scan_bwd_grouped": ("scan_bwd", "float32", P17_ROW_D_STATE),
    "selective_scan_bwd_grouped_bf16": ("scan_bwd", "bfloat16",
                                        P17_ROW_D_STATE),
    "selective_scan_bwd_grouped_f16": ("scan_bwd", "float16",
                                       P17_ROW_D_STATE),
}


def p17_geometry() -> dict:
    """The attention wrappers' geometry (route, width, rows, shared
    memory) against the CUDA side's at every head dim 1 to 512, both
    types, forward and backward, and 513 refused on both sides; the scan's
    at every d_state 1 to 256 (check_scan_geometry)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import selective_scan as SS
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for hd in FA.HEAD_DIMS:
            for bwd in (False, True):
                want = (FA.bwd_geometry if bwd else FA.geometry)(dt, hd)
                got = FA.kernel_geometry(dt, hd, bwd)
                if got != want:
                    fail(f"flash_attention{'_bwd' if bwd else ''} geometry "
                         f"at {_dtype_name(dt)} hd {hd}: kernel {got}, "
                         f"wrapper {want}")
                n += 1
        top = FA.HEAD_DIMS[-1] + 1
        if any(FA.kernel_geometry(dt, top, b) is not None
               for b in (False, True)):
            fail(f"flash_attention: the CUDA side takes hd {top}")
    print(f"  flash_attention: route, width, rows and shared memory of head "
          f"dim 1 to {FA.HEAD_DIMS[-1]}, f32 and bf16, forward and backward "
          f"({n} points), equal on both sides; {FA.HEAD_DIMS[-1] + 1} "
          f"refused")
    check_scan_geometry(SS.D_STATES)
    return {"attention_points": n, "d_states": len(SS.D_STATES)}


def sdpa_times(q, k, v, do):
    """(backend, forward ms, backward ms) of PyTorch's
    scaled_dot_product_attention, causal with GQA, on q, k, v [B, heads, S,
    hd]: the first of the flash, memory-efficient and math backends that
    takes these inputs. The yardstick only; the port never calls it."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                out = sdpa(q, k, v, is_causal=True, enable_gqa=True)
        except RuntimeError:
            continue
        with sdpa_kernel(backend):
            fwd = cuda_ms(lambda: sdpa(q, k, v, is_causal=True,
                                       enable_gqa=True), 5)
            bwd = cuda_ms(lambda: torch.autograd.grad(
                out, (q, k, v), do, retain_graph=True), 5)
        return backend.name.lower(), fwd, bwd
    fail("scaled_dot_product_attention: no backend takes the inputs")


def p17_attention(g, dev) -> list:
    """Every head dim of P17_HEAD_DIMS in f32 and bf16 at P17_ATT: the
    forward against the plain version (compare_bf16, or TOL x max|plain|
    in f32); the backward bitwise repeatable and against backward_blocks
    in f32 on the same inputs, o and lse (ATT_BWD_BF16_TOL, or TOL in
    f32); both timed beside SDPA (its backend named) and the bound, the
    plain versions timed where the case is a kernel row's (the forward's
    on the card; backward_blocks once, host clock, in tiles of
    P17_PLAIN_BLOCK rows: the f32 sums do not depend on the tiling).
    Returns records."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    B, S, H, KVH = (P17_ATT[k] for k in ("B", "S", "H", "KVH"))
    rows = {(getattr(torch, dt), n) for kind, dt, n in P17_ROWS.values()
            if kind in ("fwd", "bwd")}
    recs = []
    for hd in P17_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            name = _dtype_name(dtype)
            q, k, v, do = (torch.randn(B, S, n, hd, generator=g, device=dev)
                           .to(dtype) for n in (H, KVH, KVH, H))
            geo, bgeo = FA.geometry(dtype, hd), FA.bwd_geometry(dtype, hd)
            label = (f"B={B} S={S} H={H} KVH={KVH} hd={hd} {name} "
                     f"({FA.route(dtype, hd)} width {geo[1]}; backward "
                     f"{FA.bwd_scope(dtype, hd)} width {bgeo[1]}, "
                     f"{bgeo[2]}-row tiles)")
            plain = ref.flash_attention(q.float(), k.float(), v.float())
            o, lse = FA.flash_attention(q, k, v, lse=True)
            if dtype == torch.bfloat16:
                err = compare_bf16(f"flash_attention {label}", o, plain)
            else:
                err = compare(f"flash_attention {label}", o, plain, TOL)
            del plain
            got = FA.flash_attention_bwd(q, k, v, o, lse, do)
            again = FA.flash_attention_bwd(q, k, v, o, lse, do)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"flash_attention_bwd {label}: not bitwise repeatable")
            del again
            _sync(dev)
            t0 = time.perf_counter()
            want = FA.backward_blocks(q.float(), k.float(), v.float(),
                                      o.float(), lse, do.float(),
                                      P17_PLAIN_BLOCK)
            _sync(dev)
            bwd_plain_ms = (time.perf_counter() - t0) * 1e3
            tol = ATT_BWD_BF16_TOL if dtype == torch.bfloat16 else TOL
            b_err, b_rel = _rel_errs(got, want, f"flash_attention_bwd "
                                     f"{label}", tol)
            del got, want
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            backend, lib_ms, lib_bwd_ms = sdpa_times(
                qt, kt, vt, do.transpose(1, 2))
            cfg = dict(B=B, S=S, H=H, KVH=KVH, hd=hd, dtype=name)
            f_ms, f_by = bound("flash_attention", **cfg)
            g_ms, g_by = bound("flash_attention_bwd", **cfg)
            rec = dict(
                case=label, hd=hd, dtype=name,
                form=FA.form(dtype, hd),
                max_abs_err=err, bwd_max_abs_err=b_err,
                bwd_max_rel_err=b_rel,
                ms=cuda_ms(lambda: FA.flash_attention(q, k, v), 5),
                plain_ms=(cuda_ms(lambda: ref.flash_attention(q, k, v), 2)
                          if (dtype, hd) in rows else None),
                bound_ms=f_ms, bound_by=f_by, library=backend,
                library_ms=lib_ms,
                bwd_ms=cuda_ms(lambda: FA.flash_attention_bwd(
                    q, k, v, o, lse, do), 5),
                bwd_plain_ms=bwd_plain_ms, bwd_bound_ms=g_ms,
                bwd_bound_by=g_by, bwd_library_ms=lib_bwd_ms)
            if dtype == torch.float32 and hd > 256:
                # o's columns split over two blocks a row tile, each
                # recomputing S: the same bits, timed against the one
                # block's recompute-free launch
                split = FA.flash_attention(q, k, v, _slices=2)
                if not torch.equal(split, FA.flash_attention(q, k, v)):
                    fail(f"flash_attention {label}: two column slices "
                         "differ from one")
                rec["split_ms"] = cuda_ms(
                    lambda: FA.flash_attention(q, k, v, _slices=2), 5)
                print(f"  flash_attention {label}: o's columns over two "
                      f"slices {rec['split_ms']:.4f} ms (S recomputed), "
                      f"one {rec['ms']:.4f}; the same bits")
                del split
            print(f"  flash_attention_bwd {label}: max|diff| / max|plain| "
                  f"{b_rel:.3e} against backward_blocks in f32 (tolerance "
                  f"{tol:g}), bitwise repeatable; forward {rec['ms']:.4f} "
                  f"ms (SDPA, {backend}, {lib_ms:.4f}; bound {f_ms:.4f}), "
                  f"backward {rec['bwd_ms']:.4f} ms (SDPA {lib_bwd_ms:.4f}; "
                  f"bound {g_ms:.4f})")
            recs.append(rec)
            del q, k, v, do, o, lse, qt, kt, vt
            torch.cuda.empty_cache()
    return recs


def p17_scan(g, dev) -> list:
    """Every d_state of P17_D_STATES at P17_SCAN (T and di ragged, h0 and
    dh_last, two backward segments): the three forms forward (f32 against
    scan_lanes within SCAN_TOL, bf16 and f16 against ref.selective_scan_tree
    within TREE_TOL, the saved chunk states too); the backward of each
    form bitwise repeatable and against backward_chunks (SCAN_BWD_TOL,
    TREE_BWD_TOL). Then each form timed forward at P17_SCAN_FWD and
    backward at P17_SCAN_BWD, d_state 128 and 256; the plain versions
    timed once (host clock) at P17_ROW_D_STATE. Returns records."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import selective_scan as SS
    grads = ("d(dt)", "d(dx)", "dA", "dB", "dC", "dh0")
    recs = []

    def held(label, got, want, tol):
        """(max|diff|, max|diff| / max|plain|) over the gradients."""
        err, rel = 0.0, 0.0
        for nm, a, w in zip(grads, got, want):
            e = (a - w).abs().max().item()
            r = e / max(w.abs().max().item(), 1e-30)
            err, rel = max(err, e), max(rel, r)
            if r > tol:
                fail(f"{label} {nm}: max|diff| / max|plain| {r:.3e} above "
                     f"{tol:g}")
        return err, rel

    B, T, di = (P17_SCAN[k] for k in ("B", "T", "di"))
    for ds in P17_D_STATES:
        dt, dx, A, Bc, Cc = _scan_inputs(g, dev, B, T, di, ds, 2.0)
        h0, dh = (torch.randn(B, di, ds, generator=g, device=dev)
                  for _ in range(2))
        dy = torch.randn(B, T, di, generator=g, device=dev)
        for sd in ("float32", "bfloat16", "float16"):
            y, hl, hs = SS.selective_scan(dt, dx, A, Bc, Cc, h0,
                                          save_states=True, scan_dtype=sd)
            label = (f"selective_scan {SHORT.get(sd, 'f32')} B={B} T={T} "
                     f"di={di} ds={ds} ({SS.groups(ds)} groups), h0")
            if sd == "float32":
                wy, wh = SS.scan_lanes(dt, dx, A, Bc, Cc, h0)
                err = max(compare(f"{label} {w}", a, b, SCAN_TOL)
                          for w, a, b in (("y", y, wy), ("h_last", hl, wh)))
            else:
                wy, wh, starts = ref.selective_scan_tree(
                    dt, dx, A, Bc, Cc, h0, sd, every=SS.BT)
                err = max(compare(f"{label} {w}", a, b, TREE_TOL)
                          for w, a, b in (("y", y, wy), ("h_last", hl, wh),
                                          ("saved states", hs,
                                           torch.stack(starts, 1))))
            rec = dict(case=label, max_abs_err=err)
            got = SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh,
                                        want_dh0=True, scan_dtype=sd)
            again = SS.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh,
                                          want_dh0=True, scan_dtype=sd)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"{label} backward: not bitwise repeatable")
            want = SS.backward_chunks(dt, dx, A, Bc, Cc, dy, h0, dh,
                                      scan_dtype=sd)
            tol = SCAN_BWD_TOL if sd == "float32" else TREE_BWD_TOL
            rec["bwd_max_abs_err"], rec["bwd_max_rel_err"] = held(
                f"{label} backward", got, want, tol)
            print(f"  {label} backward ({SS.n_segments(T)} segments, "
                  f"dh_last): max|diff| / max|plain| "
                  f"{rec['bwd_max_rel_err']:.3e} against backward_chunks "
                  f"(tolerance {tol:g}), bitwise repeatable")
            del got, again, want
            recs.append(rec)
        del dt, dx, A, Bc, Cc, h0, dh, dy
        torch.cuda.empty_cache()
    for ds in P17_TIMED_D_STATES:
        B, T, di = (P17_SCAN_FWD[k] for k in ("B", "T", "di"))
        dt, dx, A, Bc, Cc = _scan_inputs(g, dev, B, T, di, ds, 4.6)
        for sd in ("float32", "bfloat16", "float16"):
            b_ms, b_by = bound("selective_scan", B=B, T=T, di=di, ds=ds,
                               scan_dtype=sd)
            plain_ms = None
            if ds == P17_ROW_D_STATE:
                _sync(dev)
                t0 = time.perf_counter()
                ref.selective_scan(dt, dx, A, Bc, Cc, None, sd)
                _sync(dev)
                plain_ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.empty_cache()
            ms = cuda_ms(lambda: SS.selective_scan(dt, dx, A, Bc, Cc,
                                                   scan_dtype=sd), 5)
            label = (f"selective_scan {SHORT.get(sd, 'f32')} B={B} T={T} "
                     f"di={di} ds={ds} ({SS.groups(ds)} groups)")
            print(f"  {label}: {ms:.4f} ms, {b_ms / ms:.3f} of the bound "
                  f"{b_ms:.4f} ms ({b_by}); plain version (one run, host "
                  f"clock) {plain_ms}")
            recs.append(dict(case=label, kind="scan", scan_dtype=sd, ds=ds,
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None))
        del dt, dx, A, Bc, Cc
        torch.cuda.empty_cache()
        B, T, di = (P17_SCAN_BWD[k] for k in ("B", "T", "di"))
        dt, dx, A, Bc, Cc = _scan_inputs(g, dev, B, T, di, ds, 4.6)
        dy = torch.randn(B, T, di, generator=g, device=dev)
        for sd in ("float32", "bfloat16", "float16"):
            _, _, hs = SS.selective_scan(dt, dx, A, Bc, Cc, save_states=True,
                                         scan_dtype=sd)
            b_ms, b_by = bound("selective_scan_bwd", B=B, T=T, di=di, ds=ds,
                               scan_dtype=sd)
            ms = cuda_ms(lambda: SS.selective_scan_bwd(
                dt, dx, A, Bc, Cc, hs, dy, scan_dtype=sd), 3)
            plain_ms = None
            if ds == P17_ROW_D_STATE:
                _sync(dev)
                t0 = time.perf_counter()
                SS.backward_chunks(dt, dx, A, Bc, Cc, dy, scan_dtype=sd)
                _sync(dev)
                plain_ms = (time.perf_counter() - t0) * 1e3
            label = (f"selective_scan_bwd {SHORT.get(sd, 'f32')} B={B} "
                     f"T={T} di={di} ds={ds} ({SS.groups(ds)} groups, "
                     f"{SS.n_segments(T)} segments)")
            print(f"  {label}: {ms:.3f} ms, {b_ms / ms:.3f} of the bound "
                  f"{b_ms:.4f} ms ({b_by}); backward_chunks (one run, host "
                  f"clock) {plain_ms}")
            recs.append(dict(case=label, kind="scan_bwd", scan_dtype=sd,
                             ds=ds, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None))
            del hs
        del dt, dx, A, Bc, Cc, dy
        torch.cuda.empty_cache()
    return recs


def p17_runs(seed: int, dev):
    """The main-path runs that take the new forms, each with the launch
    counts set to 0 just before it and read just after: Jamba v0.1 without
    experts, one period, served at d_state 256 and trained 2 steps at 128;
    StableLM-2 1.6B at full width, 8 layers, served at head_dim 72 and 320
    and trained 2 steps at 320 (4 x 2048 tokens); Whisper large-v3 at full
    width, 2 + 2 layers, served at head_dim 81; then SMOKE card vs CPU:
    StableLM at head_dim 40 and Whisper at 33 in bf16 (prefill and a train
    step), Jamba at d_state 100, scan_dtype bf16, and 129, f16 (prefill,
    decode and a train step: a last group of 36 and of 1 state), and f32
    SMOKE train steps card vs CPU on the CUDA-core kernels
    (P17_F32_SMOKE). Returns (record, launches by run)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as SV
    rec, paths, walls = {}, {}, {}
    runs = ("jamba_ds256_serve", "jamba_ds128_train", "stablelm_hd72_serve",
            "stablelm_hd320_serve", "stablelm_hd320_train",
            "whisper_hd81_serve")
    clock = [time.perf_counter()]

    def lap(key):
        """the wall s since the last lap, as ``key``"""
        now = time.perf_counter()
        walls[key] = now - clock[0]
        clock[0] = now
    jamba = get_config("jamba-v0.1-52b").with_overrides(moe=None, n_layers=8)
    rec["jamba_ds256_serve"] = lm_serve(
        "Jamba v0.1 without experts, one period (8 layers), d_state 256, "
        "bf16, prefill and decode steps from a zero cache", hybrid_steps,
        scan_cfg(jamba, d_state=256), 4, 2048, 17, seed, dev,
        ("flash_attention", "selective_scan_grouped"))
    lap("jamba_ds256_serve")
    rec["jamba_ds128_train"] = lm_train_run(
        "Jamba v0.1 without experts, one period (8 layers), d_state 128, "
        "bf16", scan_cfg(jamba, d_state=128), 2, seed, dev, repeat=False)
    lap("jamba_ds128_train")
    stablelm = get_config("stablelm-1.6b").with_overrides(n_layers=8)
    for hd, form in ((72, "tc8"), (320, "wide")):
        rec[f"stablelm_hd{hd}_serve"] = lm_serve(
            f"StableLM-2 1.6B, 8 layers, head_dim {hd}, bf16, "
            f"repro_torch.launch.serve", SV.serve,
            stablelm.with_overrides(head_dim=hd), 4, 1024, 17, seed, dev,
            (f"flash_attention_{form}",))
        lap(f"stablelm_hd{hd}_serve")
    rec["stablelm_hd320_train"] = lm_train_run(
        "StableLM-2 1.6B, 8 layers, head_dim 320, bf16",
        stablelm.with_overrides(head_dim=320), 2, seed, dev, repeat=False,
        seq=2048)
    lap("stablelm_hd320_train")
    whisper = get_config("whisper-large-v3")
    whisper = whisper.with_overrides(
        n_layers=2, head_dim=81,
        encoder=dataclasses.replace(whisper.encoder, n_layers=2))
    rec["whisper_hd81_serve"] = lm_serve(
        "Whisper large-v3, 2 + 2 layers (1,500 frames), head_dim 81, bf16, "
        "prefill and 16 decode steps from the padded cache", media_steps,
        whisper, 4, 448, 17, seed, dev, ("flash_attention_staged",))
    lap("whisper_hd81_serve")
    rec["readings"] = {
        "stablelm_hd320_prefill_s": rec["stablelm_hd320_serve"]["prefill_s"],
        "stablelm_hd320_prefill_warm_s":
            rec["stablelm_hd320_serve"]["prefill_warm_s"],
        "stablelm_hd320_train_step_s":
            rec["stablelm_hd320_train"]["s_per_step_warm"],
        "whisper_hd81_prefill_s": rec["whisper_hd81_serve"]["prefill_s"],
        "whisper_hd81_prefill_warm_s":
            rec["whisper_hd81_serve"]["prefill_warm_s"]}
    print("  phase 17's readings: " + ", ".join(
        f"{k} {v:.4f}" for k, v in rec["readings"].items()))
    for key in runs:
        paths[key] = rec[key]["launches"]
    require_launches("jamba_ds128_train", paths["jamba_ds128_train"],
                     ("flash_attention", "flash_attention_bwd",
                      "selective_scan_grouped", "selective_scan_bwd_grouped"))
    require_launches("stablelm_hd320_train", paths["stablelm_hd320_train"],
                     ("flash_attention_wide", "flash_attention_bwd_wide"))
    rec["bf16_smoke"], smoke_paths = bf16_smoke_vs_cpu(seed, dev, cases=(
        ("stablelm-1.6b", {"head_dim": 40}, ("flash_attention_tc8",),
         ("flash_attention_tc8", "flash_attention_bwd_tc8")),
        ("whisper-large-v3", {"head_dim": 33},
         ("flash_attention_staged",),
         ("flash_attention_staged", "flash_attention_bwd_staged"))))
    paths.update(smoke_paths)
    lap("bf16_smoke")
    rec["f32_smoke"] = smoke_train_vs_cpu(seed, dev, cases=P17_F32_SMOKE)
    for key, _, _ in P17_F32_SMOKE:
        paths[key] = rec["f32_smoke"][key]["launches"]
        require_launches(key, paths[key], ("flash_attention_simt",
                                           "flash_attention_bwd_simt"))
    lap("f32_smoke")
    for sd, ds in (("bfloat16", 100), ("float16", 129)):
        key = f"jamba_smoke_ds{ds}_{SHORT[sd]}"
        rec[key], paths[key] = f16_scan_smoke_vs_cpu(
            seed, dev, sd, ds, (f"selective_scan_grouped_{SHORT[sd]}",
                                f"selective_scan_bwd_grouped_{SHORT[sd]}"))
        lap(key)
    rec["walls_s"] = walls
    print("  phase 17's runs, wall s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()))
    return rec, paths


def p17_row(name, recs) -> dict:
    """The kernels line's row ``name`` (P17_ROWS) from its case's
    record."""
    kind, dt, n = P17_ROWS[name]
    if kind in ("fwd", "bwd"):
        c = next(r for r in recs if r.get("hd") == n and r["dtype"] == dt)
        pre = "" if kind == "fwd" else "bwd_"
        src = "flash_attention" + ("" if kind == "fwd" else "_bwd")
        return dict(name=name, route="cuda",
                    source=f"src/repro_torch/csrc/{src}.cu",
                    replaces="src/repro/kernels/flash_attention.py:80",
                    max_abs_err=c[f"{pre}max_abs_err"], ms=c[f"{pre}ms"],
                    plain_ms=c[f"{pre}plain_ms"],
                    bound_ms=c[f"{pre}bound_ms"],
                    bound_by=c[f"{pre}bound_by"],
                    library_ms=c[f"{pre}library_ms"],
                    library=c["library"], shape=c["case"])
    c = next(r for r in recs if r.get("kind") == kind
             and r["scan_dtype"] == dt and r["ds"] == n)
    err = "max_abs_err" if kind == "scan" else "bwd_max_abs_err"
    errs = [r[err] for r in recs if err in r
            and f" ds={n} " in r["case"] and r["case"].startswith(
                "selective_scan " + SHORT.get(dt, "f32"))]
    src = "selective_scan" + ("" if kind == "scan" else "_bwd")
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/csrc/{src}.cu",
                replaces="src/repro/kernels/selective_scan.py:69",
                max_abs_err=max(errs), ms=c["ms"], plain_ms=c["plain_ms"],
                bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                library_ms=None, shape=c["case"])


def domain_phase(seed: int, dev):
    """Phase 17: the geometry of the whole domain, the new forms against
    their plain versions and timed, then the main-path runs that take
    them. -> (kernel rows, launches by run, record)."""
    rec = {}
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    t0 = time.perf_counter()
    rec["geometry"] = p17_geometry()
    t1 = time.perf_counter()
    rec["attention"] = p17_attention(g, dev)
    t2 = time.perf_counter()
    rec["scan"] = p17_scan(g, dev)
    t3 = time.perf_counter()
    rec["kernels_s"] = t3 - t0
    print(f"  phase 17's kernel checks {rec['kernels_s']:.1f} s (geometry "
          f"{t1 - t0:.1f}, attention {t2 - t1:.1f}, scan {t3 - t2:.1f})")
    t0 = time.perf_counter()
    rec["runs"], paths = p17_runs(seed, dev)
    rec["runs_s"] = time.perf_counter() - t0
    recs = rec["attention"] + rec["scan"]
    rows = [p17_row(name, recs) for name in P17_ROWS]
    torch.cuda.empty_cache()
    return rows, paths, rec


def phase_17_alone(args, card: str, kind: str, build_s: float,
                   ptxas_new: dict) -> int:
    """``--phase 17``: phase 17 alone after the card and build steps, its
    kernel rows' launches from its own main-path runs; writes
    chiprun_out/chip_smoke_phase17.json and prints the kernels line of its
    rows, the card and the contract line."""
    dev = torch.device("cuda")
    print(f"[17] the LM kernels' whole domain ({card})")
    t0 = time.perf_counter()
    rows, paths, rec = domain_phase(args.seed, dev)
    rec["phase_s"] = time.perf_counter() - t0
    print(f"  phase 17 {rec['phase_s']:.1f} s")
    for r in rows:
        r["launches"] = sum(p.get(r["name"], 0) for p in paths.values())
        r["on_path"] = True
        if r["launches"] == 0:
            fail(f"no main-path run launched {r['name']}")
    record = {"card": card, "build_s": build_s, "ptxas_new": ptxas_new,
              "launches": paths, "domain": rec, "kernels": rows,
              "command_s": time.perf_counter() - T_START}
    print(f"chip_smoke: {record['command_s']:.1f} s from start")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_phase17.json").write_text(
        json.dumps(record, indent=1, default=str))
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "on_path")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# --rows: the kernels' rows that a change to their sources must leave where
# they were, or move, by name -> (kernel, B, S or T, H or di, KVH or ds,
# hd, dtype): Jamba's prefill and training shapes, Gemma 2B's, and the f32
# kernels at hd 64, Jamba's training shape and past 256 (320, 512); then
# the i-vector kernels (kernel, F, C, D): gmm_loglik at the paper's D = 72
# and bw_stats at the main shape, then the forms past them (gmm_loglik's
# rows form, bw_stats' pairs form), after the D = 72 rows so that what
# runs before those is the same on both trees
ROWS = {
    "flash_attention bf16 hd128 B4 S2048 32/8": ("fa", 4, 2048, 32, 8, 128,
                                                 torch.bfloat16),
    "flash_attention_bwd bf16 hd128 B1 S4096 32/8": ("fa_bwd", 1, 4096, 32, 8,
                                                     128, torch.bfloat16),
    "flash_attention bf16 hd256 B1 S4096 8/1": ("fa", 1, 4096, 8, 1, 256,
                                                torch.bfloat16),
    "flash_attention_bwd bf16 hd256 B1 S4096 8/1": ("fa_bwd", 1, 4096, 8, 1,
                                                    256, torch.bfloat16),
    "flash_attention f32 hd64 B2 S1000 8/2": ("fa", 2, 1000, 8, 2, 64,
                                              torch.float32),
    "flash_attention_bwd f32 hd64 B2 S1000 8/2": ("fa_bwd", 2, 1000, 8, 2, 64,
                                                  torch.float32),
    "flash_attention f32 hd128 B1 S4096 32/8": ("fa", 1, 4096, 32, 8, 128,
                                                torch.float32),
    "flash_attention_bwd f32 hd128 B1 S4096 32/8": ("fa_bwd", 1, 4096, 32, 8,
                                                    128, torch.float32),
    "flash_attention f32 hd320 B2 S1000 8/2": ("fa", 2, 1000, 8, 2, 320,
                                               torch.float32),
    "flash_attention_bwd f32 hd320 B2 S1000 8/2": ("fa_bwd", 2, 1000, 8, 2,
                                                   320, torch.float32),
    "flash_attention f32 hd512 B2 S1000 8/2": ("fa", 2, 1000, 8, 2, 512,
                                               torch.float32),
    "flash_attention_bwd f32 hd512 B2 S1000 8/2": ("fa_bwd", 2, 1000, 8, 2,
                                                   512, torch.float32),
    "selective_scan f32 ds16 B4 T2048 di8192": ("ss", 4, 2048, 8192, 16,
                                                None, None),
    "selective_scan_bwd f32 ds16 B1 T4096 di8192": ("ss_bwd", 1, 4096, 8192,
                                                    16, None, None),
    # the i-vector kernels: gmm_loglik (F, C, D) on SPD precisions, bw_stats
    # (F, C, D) on a random top-20 Γ
    "gmm_loglik F4096 C2048 D72": ("gl", 4096, 2048, 72, None, None, None),
    "bw_stats F32768 C2048 D72": ("bw", 32768, 2048, 72, None, None, None),
    "gmm_loglik F4096 C2048 D205": ("gl", 4096, 2048, 205, None, None, None),
    "gmm_loglik F4096 C2048 D256": ("gl", 4096, 2048, 256, None, None, None),
    "gmm_loglik F4096 C2048 D512": ("gl", 4096, 2048, 512, None, None, None),
    "bw_stats F8192 C2048 D255": ("bw", 8192, 2048, 255, None, None, None),
    "bw_stats F8192 C2048 D256": ("bw", 8192, 2048, 256, None, None, None),
}


# --rows also times PyTorch's SDPA, forward and backward, in f32 at these
# (label, B, S, H, KVH, hd): the yardstick of the f32 attention rows of
# PERF.md that had none; the port never calls it
SDPA_SHAPES = (("f32 hd128 B1 S4096 32/8", 1, 4096, 32, 8, 128),
               ("f32 hd64 B2 S1000 8/2", 2, 1000, 8, 2, 64))


def rows_alone(src: str, card: str, kind: str) -> int:
    """``--rows SRC``: the ROWS timed with the ``repro_torch`` under SRC
    (this tree's ``src``, or another tree's, such as the parent's unpacked
    by ``git archive`` into the ignored ``build/``), so that two trees can
    be compared in turns on one card (parent, change, parent, change ..);
    each row the median of 5 means of 10 launches (CUDA events; 3 for the
    i-vector rows), inputs drawn on the card from seed 0; then SDPA at
    SDPA_SHAPES (``sdpa_times``). Prints ``ROWS SRC {json}``, ``SDPA
    {json}``, the card and the contract line."""
    from repro_torch.kernels import bw_stats as BW
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import selective_scan as SS
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (k, B, S, H, KVH, hd, dt) in ROWS.items():
        n = 10
        if k == "gl":
            F, C, D = B, S, H
            const, lin, Pf = p16_precisions(C, D, g, dev)
            x = torch.randn(F, D, generator=g, device=dev)
            fn = lambda: GL.gmm_loglik(x, const, lin, Pf)   # noqa: E731
            n = 3
        elif k == "bw":
            F, C, D = B, S, H
            x = torch.randn(F, D, generator=g, device=dev)
            gamma = p16_gamma(F, C, 20, g, dev)
            fn = lambda: BW.bw_stats(gamma, x)   # noqa: E731
            n = 3
        elif k.startswith("fa"):
            q, kk, v, do = (torch.randn(B, S, n, hd, generator=g, device=dev)
                            .to(dt) for n in (H, KVH, KVH, H))
            o, lse = FA.flash_attention(q, kk, v, lse=True)
            fn = ((lambda: FA.flash_attention(q, kk, v)) if k == "fa" else
                  (lambda: FA.flash_attention_bwd(q, kk, v, o, lse, do)))
        else:
            ins = _scan_inputs(g, dev, B, S, H, KVH, 4.6)
            if k == "ss":
                fn = lambda: SS.selective_scan(*ins)   # noqa: E731
            else:
                hs = SS.selective_scan(*ins, save_states=True)[2]
                dy = torch.randn(B, S, H, generator=g, device=dev)
                fn = lambda: SS.selective_scan_bwd(*ins, hs, dy)  # noqa: E731
        times = sorted(cuda_ms(fn, n) for _ in range(5))
        out[name] = times[2]
        del fn
        torch.cuda.empty_cache()
    print("ROWS", src, json.dumps(out))
    lib = {}
    for label, B, S, H, KVH, hd in SDPA_SHAPES:
        q, kk, v, do = (torch.randn(B, n, S, hd, generator=g, device=dev)
                        for n in (H, KVH, KVH, H))
        q, kk, v = (t.requires_grad_() for t in (q, kk, v))
        backend, fwd, bwd = sdpa_times(q, kk, v, do)
        lib[label] = dict(backend=backend, fwd_ms=fwd, bwd_ms=bwd)
        del q, kk, v, do
        torch.cuda.empty_cache()
    print("SDPA", json.dumps(lib))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# --probe: the f32 CUDA-core attention at Jamba's and StableLM's training
# shapes, its kernels' time split into their parts. Each variant is the
# kernels' source with some statements switched off at run time (``if (S
# < 0)`` before them, so that the code and its registers stay as built):
# the score products, the apply products, or both, then the ring's copies
# too. What is left of a kernel with both products off is the work beside
# them (copies, barriers, softmax), whose time adds to the products'.
PROBE_SHAPES = (("Jamba", 1, 4096, 32, 8, 128),
                ("StableLM", 1, 4096, 32, 32, 64))
PROBE_OFF = {"score": {"flash_attention.cu": "      score<DC, R,",
                       "flash_attention_bwd.cu":
                           "      score_slab<R, RES, SU>("},
             "apply": dict.fromkeys(("flash_attention.cu",
                                     "flash_attention_bwd.cu"),
                                    "      apply<WC, R, KC"),
             "copies": dict.fromkeys(("flash_attention.cu",
                                      "flash_attention_bwd.cu"),
                                     "    if (c < total) {")}
PROBE_VARIANTS = {"whole": (), "no apply": ("apply",),
                  "no score": ("score",), "no products": ("score", "apply"),
                  "no products or copies": ("score", "apply", "copies")}


def probe_sources(build: Path, cuts) -> Path:
    """A copy of csrc/ under ``build`` with the statements of PROBE_OFF's
    ``cuts`` switched off in both attention sources."""
    import shutil
    from repro_torch.kernels import _build
    d = build / "_".join(("probe",) + tuple(cuts))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for fn in ("flash_attention.cu", "flash_attention_bwd.cu"):
        text = (d / fn).read_text()
        for cut in cuts:
            line = PROBE_OFF[cut][fn]
            if line not in text:
                fail(f"--probe: {fn} has no {line.strip()!r}")
            text = text.replace(line, "    if (c < total && S < 0) {"
                                if cut == "copies"
                                else "      if (S < 0)\n" + line)
        (d / fn).write_text(text)
    return d


def kernel_ms(fn, names, n: int = 3) -> dict:
    """Device ms a call of ``fn`` spends in each kernel whose name holds
    one of ``names`` (torch.profiler, ``n`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        t = getattr(e, "cuda_time_total", 0) if t is None else t
        for name in names:
            if name in e.key:
                out[name] += t / n / 1e3
    return out


def probe_alone(card: str, kind: str) -> int:
    """``--probe``: PROBE_VARIANTS of the f32 attention kernels, each
    built from its own copy of the sources, at PROBE_SHAPES: the forward's
    ms (CUDA events) and the dQ and dK/dV kernels' (profiler); and one
    f32 SGEMM (``torch.mm``, 8192 cubed, TF32 off) as the CUDA cores'
    yardstick. Prints the table and writes chiprun_out/chip_smoke_probe.
    json."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    n = 8192
    a, b = (torch.randn(n, n, device=dev) for _ in range(2))
    sgemm = 2.0 * n ** 3 / cuda_ms(lambda: torch.mm(a, b), 5) / 1e9
    print(f"  f32 SGEMM (torch.mm, {n}^3): {sgemm:.1f} TFLOP/s")
    del a, b
    build = ROOT / "build"
    dirs = {v: probe_sources(build, cuts)
            for v, cuts in PROBE_VARIANTS.items()}
    t0 = time.perf_counter()
    started, seen = [], set()
    for d in dirs.values():
        _build.CSRC = d
        for name in ("flash_attention", "flash_attention_bwd"):
            if _build.library_path(name) not in seen:
                seen.add(_build.library_path(name))
                started.append((d, name, _build._start(name)))
    for d, name, st in started:
        _build.CSRC = d
        _build._finish(name, *st)
    print(f"  {len(started)} probe libraries built in "
          f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(0)
    rec = {"card": card, "sgemm_tflops": sgemm, "rows": []}
    for label, B, S, H, KVH, hd in PROBE_SHAPES:
        q, k, v, do = (torch.randn(B, S, m, hd, generator=g, device=dev)
                       for m in (H, KVH, KVH, H))
        for variant, d in dirs.items():
            _build.CSRC = d
            _build._LIBS.clear()
            o, lse = FA.flash_attention(q, k, v, lse=True)
            row = dict(shape=label, variant=variant,
                       fwd_ms=cuda_ms(lambda: FA.flash_attention(q, k, v), 5),
                       **kernel_ms(lambda: FA.flash_attention_bwd(
                           q, k, v, o, lse, do),
                           ("dq_kernel", "dkdv_kernel")))
            print(f"  {label} f32 B={B} S={S} {H}/{KVH} hd {hd}, {variant}: "
                  f"forward {row['fwd_ms']:.4f} ms, dQ kernel "
                  f"{row['dq_kernel']:.4f}, dK/dV kernel "
                  f"{row['dkdv_kernel']:.4f}")
            rec["rows"].append(row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_probe.json").write_text(json.dumps(rec, indent=1))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


# --probe-ivector SRC: gmm_loglik's and bw_stats' wide forms, their time
# split into parts as ``--probe`` splits the attention's: each variant is
# the sources under SRC with some statements switched off at run time (a
# condition on F, which is never negative, so that the code stays as
# built). A part's statements are those of its lines that the source has:
# the lines of the forms before the rows and pairs forms (the 64-frame
# wide form, the 128-column tiles at every D) are here too, so one script
# probes either tree.
PROBE_IVEC_SHAPES = (("gmm_loglik", 4096, 2048, 256),
                     ("gmm_loglik", 4096, 2048, 205),
                     ("bw_stats", 8192, 2048, 256),
                     ("bw_stats", 8192, 2048, 255))
PROBE_IVEC_OFF = {
    # the products: each k step's loop body left at its first statement
    "products": {
        "gmm_loglik.cu": (("      float a[TM];",
                           "      if (F >= 0) break;\n      float a[TM];"),
                          ("      float2 bv[NT];",
                           "      if (F >= 0) break;\n      float2 bv[NT];")),
        "bw_stats.cu": (("      const float4 a0 = *reinterpret_cast<const "
                         "float4*>(&a_s[k * BM + ty * 4]);",
                         "      if (F >= 0) break;\n      const float4 a0 = "
                         "*reinterpret_cast<const float4*>(&a_s[k * BM + ty "
                         "* 4]);"),
                        ("      const float4 a0 = *reinterpret_cast<const "
                         "float4*>(&a_s[k * PM + ty * 4]);",
                         "      if (F >= 0) break;\n      const float4 a0 = "
                         "*reinterpret_cast<const float4*>(&a_s[k * PM + ty "
                         "* 4]);"))},
    # forming the expansion's slabs (gmm_loglik's A, bw_stats' X2)
    "formation": {
        "gmm_loglik.cu": (("    if (s + 1 < nslab) form_a(s + 1, (s + 1) "
                           "& 1);", "    if (s + 1 < nslab && F < 0) "
                           "form_a(s + 1, (s + 1) & 1);"),),
        "bw_stats.cu": (("    if (s + 1 < nslab) form_x2(s + 1, (s + 1) & "
                         "1);", "    if (s + 1 < nslab && F < 0) form_x2(s "
                         "+ 1, (s + 1) & 1);"),
                        ("    if (s + 1 < nslab) form_pairs(s + 1, (s + 1) "
                         "& 1);", "    if (s + 1 < nslab && F < 0) "
                         "form_pairs(s + 1, (s + 1) & 1);"))},
    # the copies of the streamed operand (W; Γ and x)
    "copies": {
        "gmm_loglik.cu": (("    if (nx < nslab) load_w(nx, nx % STAGES);",
                           "    if (nx < nslab && F < 0) load_w(nx, nx % "
                           "STAGES);"),),
        "bw_stats.cu": (("    if (nx < nslab) load(nx, nx % STAGES);",
                         "    if (nx < nslab && F < 0) load(nx, nx % "
                         "STAGES);"),
                        ("    if (nx < nslab) load_pairs(nx, nx % STAGES);",
                         "    if (nx < nslab && F < 0) load_pairs(nx, nx % "
                         "STAGES);"))}}
PROBE_IVEC_VARIANTS = {"whole": (), "no products": ("products",),
                       "no formation": ("formation",),
                       "no copies": ("copies",),
                       "none of them": ("products", "formation", "copies")}


def probe_ivec_sources(build: Path, cuts) -> Path:
    """A copy of csrc/ under ``build`` with PROBE_IVEC_OFF's ``cuts``
    switched off: each of a part's lines the source has; fails where it
    has none of them."""
    import shutil
    from repro_torch.kernels import _build
    d = build / "_".join(("probe_ivec",) + tuple(c[:4] for c in cuts))
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for fn in ("gmm_loglik.cu", "bw_stats.cu"):
        text = (d / fn).read_text()
        for cut in cuts:
            lines = [(a, b) for a, b in PROBE_IVEC_OFF[cut][fn] if a in text]
            if not lines:
                fail(f"--probe-ivector: {fn} has no line of {cut!r}")
            for a, b in lines:
                text = text.replace(a, b)
        (d / fn).write_text(text)
    return d


def probe_ivec_alone(src: str, card: str, kind: str) -> int:
    """``--probe-ivector SRC``: PROBE_IVEC_VARIANTS of the ``repro_torch``
    under SRC at PROBE_IVEC_SHAPES, each kernel's device ms by name
    (profiler) and the library call's (``torch.addmm`` over the packed
    expansion, ``torch.matmul(Γᵀ, X₂)``) beside them. Writes
    chiprun_out/chip_smoke_probe_ivec.json."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import bw_stats as BW
    from repro_torch.kernels import gmm_loglik as GL
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    build = ROOT / "build"
    dirs = {v: probe_ivec_sources(build, cuts)
            for v, cuts in PROBE_IVEC_VARIANTS.items()}
    t0 = time.perf_counter()
    started = []
    for d in dirs.values():
        _build.CSRC = d
        for name in ("gmm_loglik", "bw_stats"):
            started.append((d, name, _build._start(name)))
    for d, name, st in started:
        _build.CSRC = d
        _build._finish(name, *st)
    print(f"  {len(started)} probe libraries built in "
          f"{time.perf_counter() - t0:.1f} s (sources under {src})")
    g = torch.Generator(device=dev).manual_seed(0)
    rec = {"card": card, "src": src, "rows": []}
    names = ("gmm_loglik_kernel", "gmm_loglik_rows", "bw_stats_kernel",
             "bw_pairs_kernel", "bw_stats_finish", "bw_tile")
    for kernel, F, C, D in PROBE_IVEC_SHAPES:
        x = torch.randn(F, D, generator=g, device=dev)
        if kernel == "gmm_loglik":
            const, lin, Pf = p16_precisions(C, D, g, dev)
            E2 = 1 + D + D * (D + 1) // 2
            xp = ref.expand_quadratic(x)[:, 1:].contiguous()
            wp = GL.packed_weights(const, lin, Pf)[1:E2, :C].contiguous()
            lib = cuda_ms(lambda: torch.addmm(const, xp, wp), 3)
            del xp, wp
            fn = lambda: GL.gmm_loglik(x, const, lin, Pf)   # noqa: E731
        else:
            gamma = p16_gamma(F, C, 20, g, dev)
            i0, i1, _ = ref._quad_pairs(D, dev)
            x2p = torch.cat([x[:, i0] * x[:, i1], x,
                             torch.ones_like(x[:, :1])], 1)
            gT = gamma.T
            lib = cuda_ms(lambda: torch.matmul(gT, x2p), 3)
            del x2p, gT
            fn = lambda: BW.bw_stats(gamma, x)   # noqa: E731
        print(f"  {kernel} F={F} C={C} D={D}: library {lib:.4f} ms")
        for variant, d in dirs.items():
            _build.CSRC = d
            _build._LIBS.clear()
            ms = kernel_ms(fn, names)
            row = dict(kernel=kernel, F=F, C=C, D=D, variant=variant,
                       library_ms=lib, **ms)
            print(f"  {kernel} D={D}, {variant}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in ms.items() if v))
            rec["rows"].append(row)
        del x, fn
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_probe_ivec.json").write_text(json.dumps(rec,
                                                               indent=1))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=64)
    # the kill -9 drill's child process (phase 8)
    ap.add_argument("--serve-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--phase", type=int, choices=(15, 16, 17), default=None,
                    help="run only the card and build steps and this "
                    "phase, and print its kernel rows")
    ap.add_argument("--rows", default=None, metavar="SRC",
                    help="time only the LM kernels' existing rows (ROWS) "
                    "with the repro_torch package under SRC")
    ap.add_argument("--probe", action="store_true",
                    help="split the f32 attention kernels' time into "
                    "their parts (PROBE_VARIANTS)")
    ap.add_argument("--probe-ivector", default=None, metavar="SRC",
                    help="split gmm_loglik's and bw_stats' wide forms' "
                    "time into their parts (PROBE_IVEC_VARIANTS) with the "
                    "repro_torch package under SRC")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if args.serve_child is not None:
        return serve_child(Path(args.serve_child))
    sys.path.insert(0, args.rows or args.probe_ivector or str(ROOT / "src"))
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
    print(f"  exponentials: {mufu_rate()[0] / 1e12:.3f} T/s "
          f"({mufu_rate()[1]})")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), {kind}")
    if args.rows is not None:
        return rows_alone(args.rows, card, kind)
    if args.probe:
        return probe_alone(card, kind)
    if args.probe_ivector is not None:
        return probe_ivec_alone(args.probe_ivector, card, kind)

    # 2. build, then what ptxas reported in the attention's two builds of
    # their head-dim-256 instances (the bf16 forward's and backward's
    # 64-row blocks on wgmma, the f32 kernels) and of the width-512
    # tensor-core kernels (namespace wide): a spill or a serialized wgmma
    # (C7512) fails the run. Printed: every f32 CUDA-core instance
    # (namespace simt: the forward's, the dQ and dK/dV kernels', the
    # split sum; ptxas), the scan's forms at every d_state instance
    # (cuobjdump's registers and stack of the built libraries)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = ("flash_attention", "flash_attention_bwd")
    print(f"[2] build: {len(_build.SIGNATURES)} kernel libraries in "
          f"{build_s:.1f} s")
    ptxas_hd256 = ptxas_report(ptxas, "Li256E")
    ptxas_hd256.update(ptxas_report(ptxas, "wide_kernel"))
    for k, v in sorted(ptxas_hd256.items()):
        print(f"  ptxas {k}: {v}")
    for want in ("flash_attention_tc_kernelILi256E", "dq_tc_kernelILi256E",
                 "dkdv_tc_kernelILi256E", "flash_attention_wide_kernel",
                 "dq_wide_kernel", "dkdv_wide_kernel"):
        if not any(want in k for k in ptxas_hd256):
            fail(f"ptxas reported no {want} kernel")
    bad = [k for k, v in ptxas_hd256.items()
           if "C7512" in v or re.search(r"[1-9]\d* bytes spill", v)]
    if bad:
        fail(f"hd-256 and width-512 kernels spill or serialize their "
             f"wgmma: {bad}")
    ptxas_new = {}
    for key in ("Li320E", "Li384E", "Li448E", "Li512E", "4simt"):
        ptxas_new.update(ptxas_report(ptxas, key))
    ptxas_new.update(res_usage(("selective_scan", "selective_scan_bwd")))
    for k, v in sorted(ptxas_new.items()):
        print(f"  ptxas {k}: {v}")
    if args.phase == 15:
        return phase_15_alone(args, card, kind, build_s, ptxas_new)
    if args.phase == 16:
        return phase_16_alone(args, card, kind, build_s)
    if args.phase == 17:
        return phase_17_alone(args, card, kind, build_s, ptxas_new)

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
    profile = profile_path(lambda: ex.extract(utts))
    print_profile("sparse pass", profile, 8)
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

    ex_f = IVectorExtractor(cfg.with_overrides(rescore="fused"), model, ubm,
                            ServingConfig(), device=dev)
    iv_f, launches_fused, wall_f = drive(ex_f, utts, "fused")
    check_ivectors(iv_f, len(utts), cfg.ivector_dim, "fused")
    if ex_f.mode != "fused" or ex_f.stats["degradations"] != 0:
        fail(f"fused session degraded: {ex_f.stats}")
    require_launches("fused path", launches_fused, ("gmm_align",
                                                    "tvm_estep_l"))
    d_sf = float(np.abs(iv - iv_f).max())
    print(f"  sparse vs fused: max |diff| {d_sf:.3e} (tolerance {IVEC_TOL})")
    if d_sf > IVEC_TOL:
        fail("sparse and fused rungs disagree")
    del ex_f
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

    # 5. training at full width
    print("[5] training")
    del ex_c
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train = training_phase(cfg, ubm, g, args.seed, dev)
    train["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    train["phase_s"] = time.perf_counter() - t0
    print(f"  peak device memory {train['peak_mem_gb']:.2f} GB; training "
          f"phase {train['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    train["vs_cpu"] = training_vs_cpu(cfg, ubm, args.seed, dev)
    del ubm, model
    torch.cuda.empty_cache()

    # 6. the LM side: Jamba without experts, StableLM-2 1.6B, the rest of
    # the zoo, then the archs with experts
    print("[6] LM serving")
    t0 = time.perf_counter()
    lm_rows, lm_paths, lm = lm_phase(args.seed, dev)
    lm["phase_s"] = time.perf_counter() - t0
    rows += lm_rows
    print(f"  LM phase {lm['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 7. the staged recipe: train -> backend -> EER -> bundle -> from_bundle
    print("[7] recipe")
    t0 = time.perf_counter()
    recipe, recipe_paths = recipe_phase(cfg, args.seed, dev)
    recipe["phase_s"] = time.perf_counter() - t0
    print(f"  recipe phase {recipe['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 8. streaming sessions, admission and rollout on the phase-3 system
    print(f"[8] streaming sessions ({card})")
    ubm, model, _ = synthetic_system(cfg, args.seed, dev)
    t0 = time.perf_counter()
    stream, stream_paths = streaming_phase(cfg, ubm, model, utts,
                                           args.seed, dev)
    stream["phase_s"] = time.perf_counter() - t0
    print(f"  streaming phase {stream['phase_s']:.1f} s")
    del model
    torch.cuda.empty_cache()

    # 9. the supervised trainer and its fault drill
    print(f"[9] supervised training ({card})")
    t0 = time.perf_counter()
    sup, sup_paths = supervised_phase(cfg, ubm, args.seed, dev)
    sup["phase_s"] = time.perf_counter() - t0
    print(f"  supervised phase {sup['phase_s']:.1f} s")
    del ubm
    torch.cuda.empty_cache()

    # 10. the mesh of ranks on the phase-3 system, several ranks on the card
    print(f"[10] mesh of ranks over gloo on the one card ({card})")
    ubm, model, _ = synthetic_system(cfg, args.seed, dev)
    del model
    t0 = time.perf_counter()
    mesh, mesh_paths = mesh_phase(
        cfg, ubm, torch.Generator(device=dev).manual_seed(args.seed + 10),
        args.seed, dev, card)
    mesh["phase_s"] = time.perf_counter() - t0
    print(f"  mesh phase {mesh['phase_s']:.1f} s")
    del ubm
    torch.cuda.empty_cache()

    # 11. analysis/ and the kernel registry on the card
    print(f"[11] analysis ({card})")
    t0 = time.perf_counter()
    analysis = analysis_phase(cfg, utts, rows, args.seed, dev)
    analysis["phase_s"] = time.perf_counter() - t0
    print(f"  analysis phase {analysis['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 12. lowering without a cluster: meta tensors in a fake world
    print(f"[12] lowering ({card})")
    t0 = time.perf_counter()
    lowering = lowering_phase(cfg, args.seed, dev, card, mesh["mesh_2x2"])
    lowering["phase_s"] = time.perf_counter() - t0
    print(f"  lowering phase {lowering['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 13. LM training: the backward kernels, SMOKE card vs CPU, StableLM-2
    # 1.6B and the LM_TRAIN runs at full width, the supervised drill
    print(f"[13] LM training ({card})")
    t0 = time.perf_counter()
    train_rows, train_paths, lm_train = lm_training_phase(args.seed, dev)
    lm_train["phase_s"] = time.perf_counter() - t0
    rows += train_rows
    print(f"  LM training phase {lm_train['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 14. the LM mesh: sharding rules on DTensor, the ring, the MoE
    # exchange, elastic restore, the dry run's LM rows
    print(f"[14] LM mesh over gloo on the one card ({card})")
    t0 = time.perf_counter()
    lm_mesh, lm_mesh_paths = lm_mesh_phase(args.seed, dev, card)
    lm_mesh["phase_s"] = time.perf_counter() - t0
    print(f"  LM mesh phase {lm_mesh['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 15. the refusals lifted: the scan at scan_dtype bf16 and f16 and at
    # every d_state up to 64, bf16 attention at every head dim up to 256
    print(f"[15] the scan's 16-bit forms, every d_state, every bf16 head "
          f"dim ({card})")
    t0 = time.perf_counter()
    ref_rows, ref_paths, refusals = refusals_phase(args.seed, dev)
    refusals["phase_s"] = time.perf_counter() - t0
    rows += ref_rows
    print(f"  phase 15 {refusals['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 16. the i-vector kernels' shape range: gmm_align past C = 6272 at
    # K > 32 (the spill form) and past D = 234, gmm_rescore past D = 200
    # and C = 58,112, gmm_loglik past D = 204, bw_stats past D = 254; the
    # path at D = 256; train_ubm at C = 8192 with top_k=0
    print(f"[16] the i-vector kernels' shape range ({card})")
    t0 = time.perf_counter()
    shape_rows, shape_paths, shapes = shapes_phase(args.seed, dev)
    shapes["phase_s"] = time.perf_counter() - t0
    rows += shape_rows
    print(f"  phase 16 {shapes['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # 17. the LM kernels' whole domain: attention at every head dim 1 to
    # 512, the scan at every d_state 1 to 256, forward and backward
    print(f"[17] the LM kernels' whole domain ({card})")
    t0 = time.perf_counter()
    domain_rows, domain_paths, domain = domain_phase(args.seed, dev)
    domain["phase_s"] = time.perf_counter() - t0
    rows += domain_rows
    print(f"  phase 17 {domain['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # kernels line, card line, contract line. Launches are summed over
    # the main-path runs, each counted from 0: the three serving rungs, the
    # training runs, the eleven LM serving runs, the recipe's runs, the
    # streaming and demotion runs, the two supervised runs, every
    # rank's runs of the mesh phase and phase 13's LM training runs
    # (StableLM's 3 steps, 2 of each LM_TRAIN run, the supervised drill),
    # phase 15's runs (Jamba served and trained at scan_dtype bf16, the
    # bf16 SMOKE prefills and steps, the f16 and d_state-64 SMOKE runs)
    # phase 16's (the D = 256 path's train_ubm, rungs, statistics,
    # training, extraction and serving, train_ubm at C = 8192) and phase
    # 17's (Jamba at d_state 256 served and at 128 trained, StableLM at
    # head_dim 72 and 320 served and at 320 trained, Whisper at 81 served,
    # the SMOKE runs at the new head dims and d_states);
    # the repeat runs and the checks against plain paths not included.
    # packed_matmul's bf16 forms are held and timed here, but no path of
    # this script runs the E-step with bf16 inputs, and none runs
    # gmm_rescore at C above 58,112 (OFF_PATH).
    paths = {"sparse": launches_sparse, "dense": launches_dense,
             "fused": launches_fused, **train["launches"], **lm_paths,
             **recipe_paths, **stream_paths, **sup_paths, **mesh_paths,
             **train_paths, **lm_mesh_paths, **ref_paths, **shape_paths,
             **domain_paths}
    # gmm_align's row counts both entries of csrc/gmm_align.cu: the fused
    # launch and the rescore alone (gmm_rescore_fused, the mesh's fused
    # rung)
    for r in rows:
        r["launches"] = sum(p.get(r["name"], 0) + (
            p.get("gmm_rescore_fused", 0) if r["name"] == "gmm_align" else 0)
            for p in paths.values())
        r["on_path"] = r["name"] not in OFF_PATH
        if r["on_path"] and r["launches"] == 0:
            fail(f"no main-path run launched {r['name']}")
    frames = sum(u.shape[0] for u in utts)
    record = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "seed": args.seed,
              "build_s": build_s, "ptxas_hd256": ptxas_hd256,
              "setup_s": setup_s,
              "requests": len(utts), "frames": frames,
              "sparse_wall_s": [wall, wall2], "dense_wall_s": wall_d,
              "fused_wall_s": wall_f, "launches": paths,
              "peak_mem_gb_sparse": peak_gb, "profile_sparse": profile,
              "sparse_vs_dense_max_diff": d_sd,
              "sparse_vs_fused_max_diff": d_sf,
              "card_vs_cpu_max_diff": d_cpu, "training": train, "lm": lm,
              "recipe": recipe, "streaming": stream, "supervised": sup,
              "mesh": mesh, "analysis": analysis, "lowering": lowering,
              "lm_training": lm_train, "lm_mesh": lm_mesh,
              "refusals": refusals, "shapes": shapes, "domain": domain,
              "ptxas_new": ptxas_new, "kernels": rows}
    record["command_s"] = time.perf_counter() - T_START
    print(f"chip_smoke: {record['command_s']:.1f} s from start")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                    default=str))
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
