"""The paper's own model at launch scale (the port of
``repro/launch/ivector_cell.py``): one distributed EM macro-step
(alignment -> Baum-Welch -> E-step accumulation) on a mesh of ranks.

Thin shims over the engine's mesh mode (``core/engine.py``): utterances
are cut over the data axes, UBM components and T_c blocks over 'model',
and all the block math (the two-stage top-K candidate exchange, the
owner's rescore and accumulation, the E-step) is the engine's one chunk
body. This module adapts the calling convention (whole arrays in, every
rank with the same arguments; accumulators out, whole on every rank) and
keeps the analytic FLOP model.

Shapes (full config): C=2048, D=72, R=400, 8192 utts x 1024 frames a
macro-step (``IVectorConfig.utts_per_batch``, ``frames_per_utt``).

The reference's ``lower_cell`` lowers this step with XLA on a 512-device
fake mesh and reads its roofline. The port has no compiler to lower to:
its ``lower_cell`` runs rank 0's share of the step on meta tensors (no
storage, no device) in a ``fake_world`` of 256 or 512 ranks, under
``analysis/op_cost.py``'s counter with live bytes on, and
``analysis/roofline.py`` reads the counts. The CPU and the card give the
same row.
"""
from __future__ import annotations

import time

import torch

from repro_torch.analysis import op_cost
from repro_torch.analysis.roofline import roofline_from_counts
from repro_torch.configs.ivector_tvm import CONFIG
from repro_torch.core import engine as EN
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U
from repro_torch.launch import mesh as MS

f32 = torch.float32


def sharded_align_stats(cfg, mesh, diag_gmm, full_pre, feats_c,
                        second_order: bool):
    """Alignment + Baum-Welch stats with components sharded over 'model':
    one chunk of the whole batch ``feats_c`` [U, F, D] (every rank passes
    all of it) through the engine's mesh mode (``engine.stream`` with
    ``collect_nf``) -> (n [U, C], f [U, C, D], S [C, D, D]), whole on
    every rank.

    The engine's ``_align_sharded`` carries the collectives: the local
    top-min(K, C_loc) per rank, an all-gather of only the [f, P·k]
    candidates (never the [f, C] scores), a max over the model axis of
    the owner-masked selected-set logliks, the owner's accumulation with
    no stats traffic, and one exit all-reduce ('psum') of the
    accumulators over the data axes.
    """
    D = feats_c.shape[-1]
    spec = EN.EngineSpec(
        n_components=cfg.n_components, top_k=cfg.posterior_top_k,
        floor=cfg.posterior_floor,
        second_order="full" if second_order else None,
        chunk=0, rescore=getattr(cfg, "rescore", "dense"))
    pack = EN.UBMPack(None, diag_gmm, full_pre, U.rescore_pack(full_pre),
                      U.align_pack(full_pre))
    # macro-step throughput over bitwise replay: the one all-reduce
    # repro-check: disable=DET001
    (tot,), nf = EN.stream(spec, pack, MS.data_block(mesh, feats_c), None,
                           (EN.TotalsAccum(spec, D),), collect_nf=True,
                           mesh=mesh, exit_reduce="psum")
    S = (tot.ss if second_order
         else torch.zeros((cfg.n_components, D, D), dtype=f32,
                          device=mesh.device))
    return nf[0], nf[1], S


def em_macro_step(cfg, mesh, ubm_w, ubm_means, ubm_covs, T, Sigma, prior,
                  feats, utt_chunk: int = 512):
    """One EM macro-step over a global batch of utterances ``feats``
    [U, F, D] (every rank passes the whole model and batch): the engine
    streams each rank's block of utterances in chunks of ``utt_chunk``
    through alignment -> stats -> E-step accumulation, so nothing
    frame-resident ([F, C] posteriors, [u, R, R] posterior covariances)
    outlives a chunk. Only the packed [C, P] / [C, D, R] accumulators
    reduce, once, at the loop's exit ('psum'). -> (EMAccum, S [C, D, D]),
    whole on every rank.
    """
    dev = mesh.device
    ubm = U.FullGMM(ubm_w, ubm_means, ubm_covs).to(dev)
    model = TV.TVModel(T=T, Sigma=Sigma, prior=prior, means=ubm_means,
                       formulation="augmented").to(dev)
    spec = EN.EngineSpec(
        n_components=cfg.n_components, top_k=cfg.posterior_top_k,
        floor=cfg.posterior_floor,
        second_order="full" if cfg.update_sigma else None,
        chunk=utt_chunk, rescore=getattr(cfg, "rescore", "dense"))
    pre = TV.precompute(model, estep=getattr(cfg, "estep", "dense"),
                        device=dev)
    accums = (EN.TotalsAccum(spec, cfg.feat_dim),
              EN.TVMAccum(model, pre,
                          estep_dtype=getattr(cfg, "estep_dtype",
                                              "float32")))
    # repro-check: disable=DET001  (the same throughput-over-replay choice)
    (tot, acc), _ = EN.stream(spec, EN.pack_ubm(ubm, dev),
                              MS.data_block(mesh, feats), None, accums,
                              mesh=mesh, exit_reduce="psum")
    C, D = cfg.n_components, cfg.feat_dim
    S = (tot.ss if cfg.update_sigma
         else torch.zeros((C, D, D), dtype=f32, device=dev))
    return acc, S


def input_structs(cfg, shape=None):
    """The macro-step's inputs as meta tensors (shape and dtype, no
    storage): (ubm..., model..., feats). ``shape`` (with a
    ``global_batch``) overrides ``cfg.utts_per_batch``."""
    C, D, R = cfg.n_components, cfg.feat_dim, cfg.ivector_dim
    U_ = shape.global_batch if shape is not None else cfg.utts_per_batch
    F = cfg.frames_per_utt

    def sd(*s):
        return torch.empty(s, dtype=f32, device="meta")
    return dict(ubm_w=sd(C), ubm_means=sd(C, D), ubm_covs=sd(C, D, D),
                T=sd(C, D, R), Sigma=sd(C, D, D), prior=sd(R),
                feats=sd(U_, F, D))


def input_axes():
    return dict(
        ubm_w=("components",), ubm_means=("components", None),
        ubm_covs=("components", None, None),
        T=("components", None, None), Sigma=("components", None, None),
        prior=(None,),
        feats=("utts", None, None),
    )


def model_flops(cfg, n_utts: int) -> float:
    """Analytic useful FLOPs for one macro-step: alignment + Baum-Welch
    stats + E-step solves and accumulations (the reference's model). The
    fused rung reads the instance ``analysis.roofline.autotune_align``
    gives, as the reference does: each of its instances scores the packed
    [1 | x | w·x_i x_j] row (E2 = 1 + D + D(D+1)/2 products) of the K
    selected components a frame."""
    C, D, R, K = (cfg.n_components, cfg.feat_dim, cfg.ivector_dim,
                  cfg.posterior_top_k)
    F = n_utts * cfg.frames_per_utt
    align = 2.0 * F * 2 * D * C                    # diag preselect matmuls
    mode = getattr(cfg, "rescore", "dense")
    if mode == "sparse":
        align += 2.0 * F * K * (D * D + D)         # gather-and-rescore K
    elif mode == "fused":
        from repro_torch.analysis.roofline import autotune_align
        E2 = 1 + D + D * (D + 1) // 2
        tune = autotune_align(C, K, D)
        align += 2.0 * F * tune.rows_per_frame * E2
    else:
        align += 2.0 * F * (D * D + D) * C         # dense loglik matmuls
    stats = 2.0 * F * K * (D * D + D)              # sparse accumulation
    # packed-symmetric E-step: the two dominant symmetric contractions run
    # on P = R(R+1)/2 columns instead of R*R
    RR = (R * (R + 1) / 2.0 if getattr(cfg, "estep", "dense") == "packed"
          else float(R * R))
    estep_L = 2.0 * n_utts * C * RR                # n @ U contraction
    estep_rhs = 2.0 * n_utts * C * D * R
    solves = n_utts * (R ** 3) / 3.0 * 2
    accum = 2.0 * n_utts * C * (RR + D * R)
    return align + stats + estep_L + estep_rhs + solves + accum


def lower_step(cfg, mesh, utt_chunk: int = 512):
    """Rank ``mesh.rank``'s share of one ``em_macro_step`` on the meta
    inputs of ``input_structs(cfg)``, counted: -> the
    ``op_cost.OpCounter`` (live bytes on) that saw it. ``mesh`` is on
    meta: a ``fake_world``'s, or a one-rank ``Mesh`` on meta. The inputs
    are made before the counter starts, so its peak is the step's own
    storages alone."""
    args = input_structs(cfg)
    with op_cost.OpCounter(mesh, live=True) as counter:
        em_macro_step(cfg, mesh, **args, utt_chunk=utt_chunk)
    return counter


def lower_cell(shape_name: str, multi_pod: bool):
    """Lower one macro-step at ``CONFIG`` on a production mesh (the
    reference's ``lower_cell``): rank 0 of a ``fake_world`` of 256
    (16 x 16) or 512 (2 x 16 x 16) ranks runs its share on meta tensors.
    Returns (counter, row): the row is ``roofline_from_counts(...).row()``
    with ``status`` 'ok', ``lower_seconds``, the mesh's collectives by op
    (``mesh_by_op``: [calls, bytes] a rank moved) and the kernel regions
    counted from a bound on their ids (``id_bound``). Its
    ``peak_memory_per_device`` is the inputs a rank holds (every rank the
    whole model and batch) plus the step's live peak, as the reference's
    argument + temp bytes. Any shape but ``train_4k`` gives (None, a
    'skipped' row)."""
    mesh_tag = "multi" if multi_pod else "single"
    if shape_name != "train_4k":
        # the paper model has a single macro-step shape; other assigned LM
        # shapes do not apply (extra arch, not one of the 40 cells)
        return None, {"arch": "ivector-tvm", "shape": shape_name,
                      "mesh": mesh_tag, "status": "skipped",
                      "reason": "ivector-tvm defines one EM macro-step "
                                "shape; reported under train_4k only"}
    cfg = CONFIG
    t0 = time.perf_counter()
    with MS.fake_world(512 if multi_pod else 256):
        mesh = MS.make_production_mesh(multi_pod=multi_pod)
        counter = lower_step(cfg, mesh)
    inputs = sum(t.numel() * t.element_size()
                 for t in input_structs(cfg).values())
    rep = roofline_from_counts(
        counter, arch="ivector-tvm", shape=shape_name,
        mesh_desc="2x16x16" if multi_pod else "16x16", chips=mesh.size,
        model_flops=model_flops(cfg, cfg.utts_per_batch),
        peak_memory=float(inputs + counter.peak_bytes))
    row = rep.row()
    row["status"] = "ok"
    row["lower_seconds"] = time.perf_counter() - t0
    row["mesh_by_op"] = {k: list(v) for k, v in mesh.by_op.items()}
    row["id_bound"] = {k: list(v) for k, v in counter.id_bound.items()}
    return counter, row
