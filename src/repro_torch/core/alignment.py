"""Frame alignment with Kaldi's pruning recipe (the port of
``repro/core/alignment.py``), as a two-phase preselect -> rescore pipeline:

1. **preselect**: diagonal-covariance scores for all C, top-K ids per
   frame, ties broken toward the lowest id as ``lax.top_k`` does;
2. **rescore_selected**: full-covariance log-likelihood of the selected
   set, 'dense' (score all C with the ``gmm_loglik`` kernel and gather)
   or 'sparse' (score only the K selected with the ``gmm_rescore``
   kernel);
3. softmax over the selected set, drop posteriors < floor, renormalise.

'fused' runs phases 1 and 2 as one ``gmm_align`` kernel on the card: the
[F, C] diag scores never leave the chip, and the selected set is scored
through the packed-symmetric ``ubm.align_pack`` rows.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import ubm as U
from repro_torch.kernels import ops, ref

f32 = torch.float32


class SparsePosteriors(NamedTuple):
    values: torch.Tensor   # [F, K] renormalised posteriors (zeros where pruned)
    indices: torch.Tensor  # [F, K] component ids


def floor_renormalise(post, floor: float) -> torch.Tensor:
    """Floor + renormalise posteriors. If flooring would zero every
    posterior of a frame, its arg-max component is kept, so no frame
    silently drops out of the statistics."""
    keep = post >= floor
    # the arg-max mask as a comparison, not ``one_hot``: one_hot checks its
    # ids' range with two reductions on the CPU, none on the card, so the
    # two would count other bytes (``analysis/op_cost.py``)
    best = (torch.arange(post.shape[1], device=post.device)
            == torch.argmax(post, dim=1, keepdim=True))
    keep = keep | (~keep.any(dim=1, keepdim=True) & best)
    post = torch.where(keep, post, torch.zeros((), dtype=post.dtype,
                                               device=post.device))
    return post / torch.clamp(post.sum(dim=1, keepdim=True), min=1e-10)


def preselect(diag: U.DiagGMM, x, top_k: int):
    """Phase 1: diag-UBM scores [F, C] + top-K component ids [F, K], ties
    toward the lowest id as ``lax.top_k`` breaks them."""
    return ref.diag_topk(x, *U.diag_coeffs(diag), top_k)


def rescore_selected(x, sel, full, diag_ll, *, precomp=None,
                     rescore: str = "dense", rescore_pack=None):
    """Phase 2: loglik of the selected components -> [F, K].

    ``full`` None with no ``precomp`` scores the selected set with the
    diag scores already in hand (the diag phase of UBM EM). 'dense'
    evaluates all C and gathers; 'sparse' gathers first and scores only
    K, never materialising [F, C]. Both agree to f32 rounding. ('fused'
    never reaches here: ``align_frames`` runs it as one ``ops.gmm_align``
    call.)
    """
    if full is None and precomp is None:
        return torch.gather(diag_ll, 1, sel)
    if rescore == "sparse":
        return U.full_rescore(full, x, sel, precomp=precomp,
                              pack=rescore_pack)
    if rescore != "dense":
        raise ValueError(f"rescore must be 'dense' or 'sparse': {rescore}")
    ll = U.full_loglik(full, x, precomp=precomp)            # [F, C]
    return torch.gather(ll, 1, sel)


def finalise_posteriors(sel_ll, floor: float, mask=None):
    """Selected-set logliks [F, K] -> (posteriors [F, K], lse [F])."""
    lse = torch.logsumexp(sel_ll, dim=1)                     # [F]
    post = floor_renormalise(torch.exp(sel_ll - lse[:, None]), floor)
    if mask is not None:
        # where, not multiply: garbage padding frames can produce NaN/inf
        # posteriors (overflowing logliks), and NaN * 0 == NaN
        valid = mask.bool()
        zero = torch.zeros((), dtype=post.dtype, device=post.device)
        post = torch.where(valid[:, None], post, zero)
        lse = torch.where(valid, lse, zero)
    return post.to(f32), lse.to(f32)


def align_frames(x, full, diag: U.DiagGMM, *, top_k: int = 20,
                 floor: float = 0.025, precomp=None, mask=None,
                 with_loglik: bool = False, rescore: str = "dense",
                 rescore_pack=None, align_pack=None):
    """x: [F, D] -> sparse pruned-renormalised posteriors.

    Preselect with the diag UBM, score the selected components with the
    full UBM (``rescore`` 'dense', 'sparse' or 'fused': same selected set,
    same softmax/floor), floor + renormalise. 'fused' is one
    ``ops.gmm_align`` call (``align_pack`` optionally supplies its cached
    rows). ``full`` may be None: the selected components are then scored
    with the diag UBM itself.
    ``mask`` ([F], bool/0-1) marks valid frames; masked-out frames get
    all-zero posteriors. With ``with_loglik`` also returns the per-frame
    logsumexp over the selected set ([F], zeroed on masked frames).
    """
    if rescore == "fused" and not (full is None and precomp is None):
        if align_pack is None:
            align_pack = U.align_pack(
                precomp if precomp is not None else U.full_precisions(full))
        sel_ll, sel = ops.gmm_align(x, *U.diag_coeffs(diag), align_pack,
                                    top_k=top_k)
    else:
        diag_ll, sel = preselect(diag, x, top_k)           # [F, C], [F, K]
        sel_ll = rescore_selected(x, sel, full, diag_ll, precomp=precomp,
                                  rescore=rescore, rescore_pack=rescore_pack)
    post, lse = finalise_posteriors(sel_ll, floor, mask)
    out = SparsePosteriors(post, sel)
    return (out, lse) if with_loglik else out
