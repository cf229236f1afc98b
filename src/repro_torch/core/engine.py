"""The streaming align -> Baum-Welch engine (the port of
``repro/core/engine.py``, local path; the mesh mode comes with multi-GPU).

Every statistics consumer (UBM EM, TVM training, extraction, serving)
streams utterance chunks through one chunk body:

    chunk_body:  [u, F, D] feats (+ [u, F] mask)
        -> flatten frames -> alignment (diag preselect, full-cov rescoring,
           floor + renormalise)                       [alignment.py]
        -> Baum-Welch moments                         [stats.scatter_accumulate]
        -> ChunkStats(n [u, C], f [u, C, D], S, loglik, frames)

``stream`` runs it over whole chunks of ``EngineSpec.chunk`` utterances in
order, then over the exact remainder chunk, so nothing frame-resident
outlives one chunk, and feeds accumulators. An accumulator has three
methods: ``init(device)`` (the zero carry), ``update(carry, chunk)`` and
``finalize(carry)``; the carries merge in the order JAX's ``lax.scan``
and its tail merge them. ``TotalsAccum`` collects the global sufficient
statistics (UBM EM, the Σ update, the UBM refresh), ``TVMAccum`` the TVM
E-step. Per-utterance n/f for extraction come out of ``collect_nf``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import alignment as AL
from repro_torch.core import stats as ST
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U

f32 = torch.float32


@dataclass(frozen=True)
class EngineSpec:
    """Static description of one align -> stats configuration."""
    n_components: int
    top_k: int
    floor: float
    second_order: Optional[str] = None   # None | 'diag' | 'full'
    chunk: int = 0                       # utterances per chunk; 0 = all
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
    align_A: Optional[torch.Tensor] = None    # ubm.align_pack(pre): the
    # packed-symmetric [C, 1+D+D(D+1)/2] rows of the fused kernel


def pack_ubm(ubm: U.FullGMM, device=None) -> UBMPack:
    """The session pack of ``ubm`` on ``device`` (CUDA unless named)."""
    ubm = ubm.to(resolve_device(device))
    pre = U.full_precisions(ubm)
    return UBMPack(ubm, ubm.to_diag(), pre, U.rescore_pack(pre),
                   U.align_pack(pre))


def pack_diag(gmm: U.DiagGMM) -> UBMPack:
    """The pack of the diagonal phase of UBM EM: no full-covariance UBM."""
    return UBMPack(None, gmm, None, None, None)


class ChunkStats(NamedTuple):
    n: torch.Tensor               # [u, C] per-utterance occupancies
    f: torch.Tensor               # [u, C, D] per-utterance first order
    S: Optional[torch.Tensor]     # [C, D] | [C, D*D] chunk-summed | None
    loglik: torch.Tensor          # [] Σ valid-frame logsumexp (selected set)
    frames: torch.Tensor          # [] number of valid frames


class UBMStats(NamedTuple):
    """Finalized global sufficient statistics (TotalsAccum output)."""
    n: torch.Tensor               # [C]
    f: torch.Tensor               # [C, D]
    ss: Optional[torch.Tensor]    # [C, D] | [C, D, D] | None
    loglik: torch.Tensor          # []
    frames: torch.Tensor          # []


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
        rescore_pack=pack.rescore_A, align_pack=pack.align_A)
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


# ---------------------------------------------------------------------------
# Accumulators
# ---------------------------------------------------------------------------


class TotalsAccum:
    """Global sufficient statistics: Σ_u n, Σ_u f, Σ S, loglik, frames; the
    UBM M-steps, the TVM Σ update and the full UBM refresh consume them."""

    def __init__(self, spec: EngineSpec, feat_dim: int):
        self.spec = spec
        self.D = feat_dim

    def init(self, device):
        C, D = self.spec.n_components, self.D

        def z(*shape):
            return torch.zeros(shape, dtype=f32, device=device)
        S0 = {None: None, "diag": (C, D),
              "full": (C, D * D)}[self.spec.second_order]
        return (z(C), z(C, D), None if S0 is None else z(*S0), z(), z())

    def update(self, carry, chunk: ChunkStats):
        n, f, S, ll, fr = carry
        if chunk.S is not None:
            S = S + chunk.S
        return (n + chunk.n.sum(dim=0), f + chunk.f.sum(dim=0), S,
                ll + chunk.loglik, fr + chunk.frames)

    def finalize(self, carry) -> UBMStats:
        n, f, S, ll, fr = carry
        if self.spec.second_order == "full":
            S = S.reshape(self.spec.n_components, self.D, self.D)
        return UBMStats(n, f, S, ll, fr)


class TVMAccum:
    """TVM E-step accumulator: per-chunk (n, f) -> merged ``tvm.EMAccum``.

    ``center_means`` (standard formulation) centres each chunk's
    first-order stats around the UBM means before the posterior solve. A
    packed ``pre`` carries A packed through the whole stream;
    ``estep_dtype`` selects the contraction input precision (bf16 inputs,
    f32 accumulation).
    """

    def __init__(self, model: TV.TVModel, pre: TV.Precomp,
                 center_means=None, estep_dtype: str = "float32"):
        self.model = model
        self.pre = pre
        self.center_means = center_means
        self.estep_dtype = estep_dtype

    def init(self, device):
        C, D, R = self.model.T.shape
        return TV.EMAccum.zeros(
            C, D, R, estep="packed" if self.pre.packed else "dense",
            device=device)

    def update(self, carry, chunk: ChunkStats):
        n, f = chunk.n, chunk.f
        if self.center_means is not None:
            st = ST.center(ST.BWStats(n, f, None), self.center_means)
            n, f = st.n, st.f
        return TV.merge_accums(
            carry, TV.em_accumulate(self.model, self.pre, n, f,
                                    estep_dtype=self.estep_dtype))

    def finalize(self, carry) -> TV.EMAccum:
        return carry


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------


def stream(spec: EngineSpec, pack: UBMPack, feats, mask,
           accums: Sequence, collect_nf: bool = False):
    """Stream ``chunk_body`` over utterance chunks, feeding ``accums``: whole
    chunks of ``spec.chunk`` utterances in order, then the exact remainder
    chunk (the JAX ``_stream_local``'s scan and tail).

    feats: [U, F, D]; mask: [U, F] or None. Returns
    (tuple of finalized accumulator results,
     (n [U, C], f [U, C, D]) if ``collect_nf`` else None).
    """
    n_utts = feats.shape[0]
    chunk = n_utts if spec.chunk <= 0 else min(spec.chunk, n_utts)
    carries = tuple(a.init(feats.device) for a in accums)
    ns, fs = [], []
    for s in range(0, n_utts, chunk):
        cs = chunk_body(spec, pack, feats[s:s + chunk],
                        None if mask is None else mask[s:s + chunk])
        carries = tuple(a.update(c, cs) for a, c in zip(accums, carries))
        if collect_nf:
            ns.append(cs.n)
            fs.append(cs.f)
    results = tuple(a.finalize(c) for a, c in zip(accums, carries))
    return results, ((torch.cat(ns), torch.cat(fs)) if collect_nf else None)


def stream_bw(spec: EngineSpec, pack: UBMPack, feats, mask=None):
    """Streamed Baum-Welch stats with per-utterance n/f (extraction and
    the TVM stats path): -> (BWStats, (loglik, frames))."""
    (tot,), nf = stream(spec, pack, feats, mask,
                        (TotalsAccum(spec, feats.shape[-1]),),
                        collect_nf=True)
    return ST.BWStats(nf[0], nf[1], tot.ss), (tot.loglik, tot.frames)


def stream_ubm(spec: EngineSpec, pack: UBMPack, feats,
               mask=None) -> UBMStats:
    """Streamed global sufficient statistics (UBM EM): no per-utterance
    arrays are kept."""
    (tot,), _ = stream(spec, pack, feats, mask,
                       (TotalsAccum(spec, feats.shape[-1]),))
    return tot
