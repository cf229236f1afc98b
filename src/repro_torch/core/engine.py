"""The streaming align -> Baum-Welch engine (the port of
``repro/core/engine.py``), on one device or on a mesh of ranks.

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

Mesh mode (``stream(..., mesh=...)``, ``launch/mesh.py``): every rank runs
the same loop on its block of the utterances (the data axes) against its
block of the component rows (``'model'``): the chunk body stays the one
source of truth, and only the alignment's selection changes
(``_align_sharded``: a diag preselect over the local rows, a two-stage
top-K over the gathered candidates, the owner's rescore and a max over
the model axis, then the same ``finalise_posteriors`` and
``scatter_accumulate`` tail). The accumulators then take two structural
hooks, the reference's mesh protocol:

    with_mesh(spec, mesh)   -> the rank-local clone (its component rows)
    mesh_out_specs()        -> per leaf of finalize()'s result: 'model'
                               (rows sharded over the model axis) or None
                               (replicated)

and their finalised results reduce over the data axes once, at the exit
of the chunk loop ('ordered': gathered and folded left in rank order;
'psum': one all-reduce), then the model-sharded rows are gathered, so
every rank holds the whole result. A one-rank mesh takes the local path
bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import alignment as AL
from repro_torch.core import stats as ST
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as MS

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


def _pack_rows(mesh: MS.Mesh, pack: UBMPack) -> UBMPack:
    """This rank's component rows of the leaves ``_align_sharded`` scores
    against (``pre``, ``rescore_A``, ``align_A``; each has leading dim C),
    sliced from the whole pack so that every row is the one the local
    path scores against, bit for bit. The GMMs themselves are not needed
    there: the preselection takes ``_diag_rows``."""
    rows = functools.partial(MS.model_rows, mesh)
    pre = None if pack.pre is None else tuple(rows(t) for t in pack.pre)
    return UBMPack(None, None, pre, rows(pack.rescore_A),
                   rows(pack.align_A))


def _diag_rows(mesh: MS.Mesh, diag: U.DiagGMM):
    """This rank's block of the diag preselection coefficients (const [C],
    lin and quad [D, C]), cut from the whole model's."""
    c, lin, quad = U.diag_coeffs(diag)
    Cl = c.shape[0] // mesh.model_extent
    cols = slice(mesh.model_rank * Cl, (mesh.model_rank + 1) * Cl)
    return (MS.model_rows(mesh, c), lin[:, cols].contiguous(),
            quad[:, cols].contiguous())


def _align_sharded(spec: EngineSpec, pack: UBMPack, coeffs, x, m,
                   mesh: MS.Mesh):
    """Alignment of flattened frames against this rank's block of C_loc
    components, collectives explicit (the reference's ``_align_sharded``):

      1. a diag preselect over the local block (``coeffs``, the rank's
         columns of the whole model's ``diag_coeffs``);
      2. a two-stage top-K: the local top-min(K, C_loc), an all-gather of
         only the [f, k_loc] candidates and their global ids over the
         model axis, then the global top-K, ties toward the lowest
         position of the rank-ordered gather (``ref.topk_lowest``): that
         is the lowest global id, as on one device;
      3. the loglik of the selected set per ``spec.rescore`` ('sparse'
         ``gmm_rescore``, 'fused' ``gmm_rescore_fused`` against the
         local rows, 'dense' ``gmm_loglik`` over the block and a gather),
         -inf on the slots another rank owns, and a max over the model
         axis (each component has one owner);
      4. the same ``alignment.finalise_posteriors`` tail as the local path.

    Returns (values [f, K] owner-masked posteriors, indices [f, K] LOCAL
    component ids (0 on the slots another rank owns), lse [f]
    replicated): the accumulation then runs on the owner alone.
    """
    group = mesh.groups["model"]
    r = mesh.model_rank
    C_loc = coeffs[0].shape[0]
    K = spec.top_k
    dll, li = ref.diag_topk(x, *coeffs, min(K, C_loc))  # [f, C_loc], [f, k]
    lv = torch.gather(dll, 1, li)
    gi = li + r * C_loc                                  # global ids
    lv_all = torch.cat(MS.all_gather(mesh, lv, group, "model"), dim=1)
    gi_all = torch.cat(MS.all_gather(mesh, gi, group, "model"), dim=1)
    sel = torch.gather(gi_all, 1, ref.topk_lowest(lv_all, K))  # [f, K]
    own = torch.div(sel, C_loc, rounding_mode="floor") == r
    loc = torch.where(own, sel % C_loc, torch.zeros_like(sel))
    if pack.pre is None:
        # diag phase: the preselection scores are the selected-set scores
        vals = torch.gather(dll, 1, loc)
    elif spec.rescore == "sparse":
        fc, fl, fP = pack.pre
        vals = ops.gmm_rescore(x, loc, fc, fl.T, fP.reshape(C_loc, -1),
                               pack=pack.rescore_A)
    elif spec.rescore == "fused":
        vals = ops.gmm_rescore_fused(x, loc, pack.align_A)
    elif spec.rescore == "dense":
        fc, fl, fP = pack.pre
        fll = ops.gmm_loglik(x, fc, fl.T, fP.reshape(C_loc, -1))
        vals = torch.gather(fll, 1, loc)
    else:
        raise ValueError(f"rescore must be 'dense', 'sparse' or 'fused': "
                         f"{spec.rescore}")
    vals = torch.where(own, vals, torch.full((), -torch.inf, dtype=f32,
                                             device=vals.device))
    sel_ll = MS.all_reduce(mesh, vals, group, "model", op="max")
    post, lse = AL.finalise_posteriors(sel_ll, spec.floor, m)
    return torch.where(own, post, torch.zeros((), dtype=f32,
                                              device=post.device)), loc, lse


def chunk_body(spec: EngineSpec, pack: UBMPack, feats_c,
               mask_c=None, mesh: Optional[MS.Mesh] = None,
               coeffs=None) -> ChunkStats:
    """THE canonical align -> BW-stats body for one utterance chunk.

    feats_c: [u, F, D]; mask_c: [u, F] optional. Frames are flattened so
    alignment is one batched pass; the accumulation groups statistics
    back by utterance.

    With ``mesh`` (the engine's mesh mode, model extent above 1) the
    component dimension is the rank's block: alignment runs through
    ``_align_sharded`` against ``pack``'s local rows and the preselection
    ``coeffs``, and the accumulation stays with the owner. The loglik and
    frame counters come out replicated over the model axis.
    """
    u, F, D = feats_c.shape
    x = feats_c.reshape(u * F, D)
    m = None if mask_c is None else mask_c.reshape(u * F)
    if mesh is None:
        post, lse = AL.align_frames(
            x, pack.full, pack.diag, top_k=spec.top_k, floor=spec.floor,
            precomp=pack.pre, mask=m, with_loglik=True,
            rescore=spec.rescore, rescore_pack=pack.rescore_A,
            align_pack=pack.align_A)
        values, indices = post.values, post.indices
    else:
        values, indices, lse = _align_sharded(spec, pack, coeffs, x, m, mesh)
    n, f, S = ST.scatter_accumulate(
        x, values, indices, u, spec.n_components,
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

    # -- mesh protocol ------------------------------------------------------

    def with_mesh(self, spec: EngineSpec, mesh) -> "TotalsAccum":
        return TotalsAccum(spec, self.D)

    def mesh_out_specs(self) -> UBMStats:
        """n/f/S stay with the owner of their rows; loglik and frames come
        out of the chunk body replicated over the model axis."""
        return UBMStats(n="model", f="model",
                        ss=None if self.spec.second_order is None
                        else "model", loglik=None, frames=None)


class TVMAccum:
    """TVM E-step accumulator: per-chunk (n, f) -> merged ``tvm.EMAccum``.

    ``center_means`` (standard formulation) centres each chunk's
    first-order stats around the UBM means before the posterior solve. A
    packed ``pre`` carries A packed through the whole stream;
    ``estep_dtype`` selects the contraction input precision (bf16 inputs,
    f32 accumulation).

    In mesh mode (``axis``, set by ``with_mesh``, is the mesh whose model
    axis is sharded) the E-step contractions run on the rank's block of
    components: the partial precision rows [u, P] and rhs [u, R] sum over
    the model axis inside ``tvm.posterior`` (the E-step's only model-axis
    collective), then A/B/n_tot stay rows of the owner and h/H/n_utts
    are replicated: the layout the exit reduce carries.
    """

    def __init__(self, model: TV.TVModel, pre: TV.Precomp,
                 center_means=None, estep_dtype: str = "float32",
                 axis=None):
        self.model = model
        self.pre = pre
        self.center_means = center_means
        self.estep_dtype = estep_dtype
        self.axis = axis

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
                                    estep_dtype=self.estep_dtype,
                                    axis=self.axis))

    def finalize(self, carry) -> TV.EMAccum:
        return carry

    # -- mesh protocol ------------------------------------------------------

    def with_mesh(self, spec: EngineSpec, mesh) -> "TVMAccum":
        if mesh.model_extent == 1:
            return self
        rows = functools.partial(MS.model_rows, mesh)
        m = self.model
        model = TV.TVModel(rows(m.T), rows(m.Sigma), m.prior, rows(m.means),
                           m.formulation)
        return TVMAccum(model, TV.Precomp(rows(self.pre.U),
                                          rows(self.pre.Pj)),
                        center_means=rows(self.center_means),
                        estep_dtype=self.estep_dtype, axis=mesh)

    def mesh_out_specs(self) -> TV.EMAccum:
        return TV.EMAccum(A="model", B="model", h=None, H=None,
                          n_tot="model", n_utts=None)


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------


def _stream_local(spec: EngineSpec, pack: UBMPack, feats, mask,
                  accums: Sequence, collect_nf: bool = False,
                  mesh: Optional[MS.Mesh] = None, coeffs=None):
    """Whole chunks of ``spec.chunk`` utterances in order, then the exact
    remainder chunk (the JAX ``_stream_local``'s scan and tail), feeding
    ``accums``. ``mesh``/``coeffs``: the model-sharded chunk body."""
    n_utts = feats.shape[0]
    chunk = n_utts if spec.chunk <= 0 else min(spec.chunk, n_utts)
    carries = tuple(a.init(feats.device) for a in accums)
    ns, fs = [], []
    for s in range(0, n_utts, chunk):
        cs = chunk_body(spec, pack, feats[s:s + chunk],
                        None if mask is None else mask[s:s + chunk],
                        mesh=mesh, coeffs=coeffs)
        carries = tuple(a.update(c, cs) for a, c in zip(accums, carries))
        if collect_nf:
            ns.append(cs.n)
            fs.append(cs.f)
    results = tuple(a.finalize(c) for a, c in zip(accums, carries))
    return results, ((torch.cat(ns), torch.cat(fs)) if collect_nf else None)


def _ordered_data_sum(mesh: MS.Mesh, x):
    """Deterministic data-axis reduction: all-gather the per-rank partials
    and fold them left in rank order. It reproduces the one-device loop's
    merges bit for bit when each rank holds exactly one chunk (the chunk
    size is U / data extent), the merges then being ((c0 + c1) + c2) ...
    as on one device; with several chunks a rank, (c0 + c1) + (c2 + c3)
    is not ((c0 + c1) + c2) + c3. Costs the data extent times the bytes
    of 'psum'."""
    g = MS.all_gather(mesh, x, mesh.data_group, "exit")
    acc = g[0]
    for t in g[1:]:
        acc = acc + t
    return acc


def _check_exit_reduce(exit_reduce: str) -> None:
    if exit_reduce not in ("ordered", "psum"):
        raise ValueError(f"exit_reduce must be 'ordered' or 'psum': "
                         f"{exit_reduce!r}")


def reduce_partials(mesh: MS.Mesh, accums: Sequence, results,
                    exit_reduce: str = "ordered"):
    """The exit of the chunk loop: each finalised per-rank result of
    ``accums`` reduced over the data axes ('ordered' or 'psum'), then its
    model-sharded rows (``mesh_out_specs``) gathered in rank order, so
    that every rank holds the whole result."""
    _check_exit_reduce(exit_reduce)
    if mesh is None or mesh.size == 1:
        return tuple(results)

    def reduce(x, spec):
        if x is None:
            return None
        if mesh.data_group is not None:
            x = (_ordered_data_sum(mesh, x) if exit_reduce == "ordered"
                 else MS.all_reduce(mesh, x.clone(), mesh.data_group,
                                    "exit"))
        if spec == "model":
            x = torch.cat(MS.all_gather(mesh, x, mesh.groups["model"],
                                        "gather"))
        return x

    return tuple(type(r)(*(reduce(x, sp) for x, sp in
                           zip(r, a.mesh_out_specs())))
                 for a, r in zip(accums, results))


def stream_partial(spec: EngineSpec, pack: UBMPack, feats, mask,
                   accums: Sequence, collect_nf: bool = False,
                   mesh: Optional[MS.Mesh] = None):
    """This rank's part of ``stream``: the chunk loop over the rank's
    block of utterances (``feats``/``mask``: ``launch.mesh.data_block`` of
    the global batch) against its block of the component rows of
    ``pack`` and of the accumulators' operands, with no exit reduce.
    Returns (per-rank finalised results, local (n [u, C_loc], f) or
    None); ``reduce_partials`` finishes them. Partials merged rank-locally
    (a macro-batched pass) then reduced once are bitwise ``stream``'s
    results when the merges match its chunk loop's."""
    if mesh is None or mesh.size == 1:
        return _stream_local(spec, pack, feats, mask, accums, collect_nf)
    C, Pm = spec.n_components, mesh.model_extent
    if C % Pm:
        raise ValueError(f"n_components={C} does not divide the mesh's "
                         f"model extent {Pm}")
    spec_loc = dataclasses.replace(spec, n_components=C // Pm)
    accs = tuple(a.with_mesh(spec_loc, mesh) for a in accums)
    if Pm == 1:
        # no model-axis collectives: the local alignment, bit for bit
        return _stream_local(spec_loc, pack, feats, mask, accs, collect_nf)
    return _stream_local(spec_loc, _pack_rows(mesh, pack), feats, mask,
                         accs, collect_nf, mesh=mesh,
                         coeffs=_diag_rows(mesh, pack.diag))


def _gather_nf(mesh: MS.Mesh, nf):
    """Per-utterance (n, f) of every rank, in rank order: [U, C], [U, C, D]."""
    n, f = nf
    if mesh.model_extent > 1:
        g = mesh.groups["model"]
        n = torch.cat(MS.all_gather(mesh, n, g, "gather"), dim=1)
        f = torch.cat(MS.all_gather(mesh, f, g, "gather"), dim=1)
    if mesh.data_group is not None:
        n = torch.cat(MS.all_gather(mesh, n, mesh.data_group, "gather"))
        f = torch.cat(MS.all_gather(mesh, f, mesh.data_group, "gather"))
    return n, f


def _stream_sharded(spec: EngineSpec, pack: UBMPack, feats, mask,
                    accums: Sequence, collect_nf: bool, mesh: MS.Mesh,
                    exit_reduce: str = "ordered"):
    """The mesh mode: ``stream_partial`` on every rank, then ONE reduce of
    the finalised results over the data axes at the loop's exit
    (``reduce_partials``). ``exit_reduce`` 'ordered' (default) folds the
    gathered partials in rank order, bitwise the one-device loop when each
    rank holds one chunk; 'psum' is one all-reduce (the sum in the
    backend's order). Per-utterance n/f are gathered in rank order."""
    _check_exit_reduce(exit_reduce)
    results, nf = stream_partial(spec, pack, feats, mask, accums,
                                 collect_nf, mesh)
    results = reduce_partials(mesh, accums, results, exit_reduce)
    return results, (_gather_nf(mesh, nf) if collect_nf else None)


def stream(spec: EngineSpec, pack: UBMPack, feats, mask,
           accums: Sequence, collect_nf: bool = False,
           mesh: Optional[MS.Mesh] = None, exit_reduce: str = "ordered"):
    """Stream ``chunk_body`` over utterance chunks, feeding ``accums``: whole
    chunks of ``spec.chunk`` utterances in order, then the exact remainder
    chunk (the JAX ``_stream_local``'s scan and tail).

    feats: [U, F, D]; mask: [U, F] or None. Returns
    (tuple of finalized accumulator results,
     (n [U, C], f [U, C, D]) if ``collect_nf`` else None).

    ``mesh`` None or of one rank streams locally. A larger mesh runs the
    same loop on every rank: ``feats``/``mask`` are then the rank's block
    of the global batch (``launch.mesh.data_block``), ``pack`` and the
    accumulators' operands the whole model (each rank takes its component
    rows), and every rank gets the whole results, reduced once at the
    loop's exit, and the whole per-utterance n/f. With ``'ordered'`` a
    data-only mesh whose ranks hold one chunk each reproduces the
    one-device results bit for bit; 'psum' and model-sharded meshes agree
    up to f32 reassociation.
    """
    if mesh is None or mesh.size == 1:
        return _stream_local(spec, pack, feats, mask, accums, collect_nf)
    return _stream_sharded(spec, pack, feats, mask, accums, collect_nf,
                           mesh, exit_reduce=exit_reduce)


def stream_bw(spec: EngineSpec, pack: UBMPack, feats, mask=None,
              mesh: Optional[MS.Mesh] = None):
    """Streamed Baum-Welch stats with per-utterance n/f (extraction and
    the TVM stats path): -> (BWStats, (loglik, frames))."""
    (tot,), nf = stream(spec, pack, feats, mask,
                        (TotalsAccum(spec, feats.shape[-1]),),
                        collect_nf=True, mesh=mesh)
    return ST.BWStats(nf[0], nf[1], tot.ss), (tot.loglik, tot.frames)


def stream_ubm(spec: EngineSpec, pack: UBMPack, feats,
               mask=None, mesh: Optional[MS.Mesh] = None) -> UBMStats:
    """Streamed global sufficient statistics (UBM EM): no per-utterance
    arrays are kept."""
    (tot,), _ = stream(spec, pack, feats, mask,
                       (TotalsAccum(spec, feats.shape[-1]),), mesh=mesh)
    return tot
