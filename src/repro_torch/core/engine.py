"""The align -> Baum-Welch chunk body (the port of ``repro/core/engine.py``,
local path only; the streaming scan, accumulators and mesh mode come with
training and multi-GPU).

    chunk_body:  [u, F, D] feats (+ [u, F] mask)
        -> flatten frames -> alignment (diag preselect, full-cov rescoring,
           floor + renormalise)                       [alignment.py]
        -> Baum-Welch moments                         [stats.scatter_accumulate]
        -> ChunkStats(n [u, C], f [u, C, D], S, loglik, frames)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import alignment as AL
from repro_torch.core import stats as ST
from repro_torch.core import ubm as U

f32 = torch.float32


@dataclass(frozen=True)
class EngineSpec:
    """Static description of one align -> stats configuration."""
    n_components: int
    top_k: int
    floor: float
    second_order: Optional[str] = None   # None | 'diag' | 'full'
    rescore: str = "dense"               # 'dense' | 'sparse' | 'fused'


# The rescoring fallback ladder, fastest first: a runtime failure of one
# mode demotes to the next. Every mode feeds the identical downstream
# math, so demotion is a speed decision, not a semantic one.
RESCORE_LADDER = ("fused", "sparse", "dense")


def degrade_rescore(mode: str) -> Optional[str]:
    """The next-safer rescore mode, or None when already at 'dense' (the
    reference path: a failure there is a real bug, not a kernel issue)."""
    i = RESCORE_LADDER.index(mode)
    return RESCORE_LADDER[i + 1] if i + 1 < len(RESCORE_LADDER) else None


class UBMPack(NamedTuple):
    """The per-model precompute the chunk body scores against, built once
    per session."""
    full: Optional[U.FullGMM]     # None => diag-only scoring
    diag: U.DiagGMM               # preselection (and diag-phase) GMM
    pre: Optional[Tuple]          # full_precisions(full)
    rescore_A: Optional[torch.Tensor] = None  # ubm.rescore_pack(pre): the
    # packed [C, 1+D+D²] rows the sparse rescoring kernel gathers
    align_A: Optional[torch.Tensor] = None    # the fused path's rows: None
    # until the gmm_align kernel lands


def pack_ubm(ubm: U.FullGMM, device=None) -> UBMPack:
    """The session pack of ``ubm`` on ``device`` (CUDA unless named)."""
    ubm = ubm.to(resolve_device(device))
    pre = U.full_precisions(ubm)
    return UBMPack(ubm, ubm.to_diag(), pre, U.rescore_pack(pre))


class ChunkStats(NamedTuple):
    n: torch.Tensor               # [u, C] per-utterance occupancies
    f: torch.Tensor               # [u, C, D] per-utterance first order
    S: Optional[torch.Tensor]     # [C, D] | [C, D*D] chunk-summed | None
    loglik: torch.Tensor          # [] Σ valid-frame logsumexp (selected set)
    frames: torch.Tensor          # [] number of valid frames


def chunk_body(spec: EngineSpec, pack: UBMPack, feats_c,
               mask_c=None) -> ChunkStats:
    """THE canonical align -> BW-stats body for one utterance chunk.

    feats_c: [u, F, D]; mask_c: [u, F] optional. Frames are flattened so
    alignment is one batched pass; the accumulation groups statistics
    back by utterance.
    """
    u, F, D = feats_c.shape
    x = feats_c.reshape(u * F, D)
    m = None if mask_c is None else mask_c.reshape(u * F)
    post, lse = AL.align_frames(
        x, pack.full, pack.diag, top_k=spec.top_k, floor=spec.floor,
        precomp=pack.pre, mask=m, with_loglik=True, rescore=spec.rescore,
        rescore_pack=pack.rescore_A)
    n, f, S = ST.scatter_accumulate(
        x, post.values, post.indices, u, spec.n_components,
        second_order=spec.second_order, mask=m)
    frames = (torch.tensor(u * F, dtype=f32, device=x.device)
              if m is None else m.to(f32).sum())
    return ChunkStats(n, f, S, lse.sum(), frames)


def session_stats(spec: EngineSpec, pack: UBMPack, feats, mask=None):
    """One streaming-session chunk: [F, D] frames (+ optional [F] mask)
    -> (n [C], f [C, D], loglik [], frames []), through ``chunk_body``."""
    cs = chunk_body(spec, pack, feats[None],
                    None if mask is None else mask[None])
    return cs.n[0], cs.f[0], cs.loglik, cs.frames
