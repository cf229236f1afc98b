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
fake mesh and reads its roofline; here ``analysis/op_cost.py`` counts a
step as it runs and ``analysis/roofline.py`` reads it. ``lower_cell``
waits for ``launch/dryrun.py`` (ROADMAP Queue 1 item 13e).
"""
from __future__ import annotations

import torch

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
