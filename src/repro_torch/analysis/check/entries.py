"""Registered entry points the dispatch pass runs (the port's copy of
``repro/analysis/check/entries.py``: the same eight entries over the
port's modules, at the same toy sizes).

Each entry builds DETERMINISTIC toy operands (no generator: analysis code
must itself lint clean, and a fixed linspace is as good a probe shape as
a random draw) on the device the caller names, and declares input roles
for the mask-domination taint. The frame count is prime (F=97) so the
frame axis is identified by extent without aliasing C/D/K/R; U=3 keeps
U*F != F unambiguous.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core import alignment, backend, engine, tvm, ubm

f32 = torch.float32

C, D, K, R = 8, 6, 4, 8
F, U = 97, 3


class Entry(NamedTuple):
    name: str
    fn: Callable
    args: tuple
    roles: Sequence[Optional[str]]
    frame_extent: Optional[tuple] = None


def _lin(a: float, b: float, *shape, dev) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return torch.linspace(a, b, n, dtype=f32, device=dev).reshape(shape)


def _toy_full_gmm(dev) -> ubm.FullGMM:
    means = _lin(-1.0, 1.0, C, D, dev=dev)
    v = _lin(0.5, 1.5, C, D, dev=dev)
    covs = torch.diag_embed(v) + 0.05 * torch.ones((C, D, D), device=dev)
    weights = torch.full((C,), 1.0 / C, dtype=f32, device=dev)
    return ubm.FullGMM(weights, means, covs)


def _toy_feats(dev):
    x = _lin(-2.0, 2.0, U, F, D, dev=dev)
    lens = torch.tensor([F, 80, 55], device=dev)
    mask = torch.arange(F, device=dev)[None, :] < lens[:, None]
    return x, mask.to(f32)


def _toy_stats(dev):
    return (_lin(0.1, 5.0, U, C, dev=dev), _lin(-1.0, 1.0, U, C, D, dev=dev))


def _toy_tvm(dev, estep: str = "dense"):
    gmm = _toy_full_gmm(dev)
    # deterministic full-rank T: shifted linspace folded per component
    T = (_lin(-0.5, 0.5, C, D, R, dev=dev)
         + 0.01 * torch.eye(D, R, device=dev)[None])
    model = tvm.TVModel(T=T, Sigma=gmm.covs,
                        prior=torch.zeros((R,), dtype=f32, device=dev),
                        means=gmm.means, formulation="standard")
    return model, tvm.precompute(model, estep=estep, device=dev)


def build_entries(device=None) -> List[Entry]:
    """The eight entries, their operands on ``device`` (the card unless
    the caller names another)."""
    dev = resolve_device(device)
    gmm = _toy_full_gmm(dev)
    pack = engine.pack_ubm(gmm, dev)
    feats, mask = _toy_feats(dev)
    n, f = _toy_stats(dev)
    model, pre = _toy_tvm(dev, "dense")
    model_p, pre_p = _toy_tvm(dev, "packed")
    spec = engine.EngineSpec(n_components=C, top_k=K, floor=0.025,
                             second_order="full", rescore="dense")

    ivecs = _lin(-1.0, 1.0, 6, R, dev=dev)
    eye = torch.eye(R, dtype=f32, device=dev)
    plda = backend.PLDA(mean=torch.zeros((R,), dtype=f32, device=dev),
                        B=eye * 0.8 + 0.1, W=eye * 0.5 + 0.05)

    frames = (F, U * F)
    return [
        Entry("engine.chunk_body",
              lambda p, x, m: engine.chunk_body(spec, p, x, m),
              (pack, feats, mask), (None, "feats", "mask"), frames),
        Entry("alignment.align_frames",
              lambda fu, di, x, m: alignment.align_frames(
                  x, fu, di, top_k=K, mask=m, with_loglik=True),
              (gmm, gmm.to_diag(), feats.reshape(U * F, D),
               mask.reshape(U * F)),
              (None, None, "feats", "mask"), frames),
        Entry("tvm.posterior",
              lambda mo, pr, nn, ff: tvm.posterior(mo, pr, nn, ff),
              (model, pre, n, f), (None, None, None, None)),
        Entry("tvm.posterior[packed,bf16]",
              lambda mo, pr, nn, ff: tvm.posterior(
                  mo, pr, nn, ff, estep_dtype="bfloat16"),
              (model_p, pre_p, n, f), (None, None, None, None)),
        Entry("tvm.em_accumulate",
              lambda mo, pr, nn, ff: tvm.em_accumulate(mo, pr, nn, ff),
              (model, pre, n, f), (None, None, None, None)),
        Entry("tvm.em_accumulate[packed,bf16]",
              lambda mo, pr, nn, ff: tvm.em_accumulate(
                  mo, pr, nn, ff, estep_dtype="bfloat16"),
              (model_p, pre_p, n, f), (None, None, None, None)),
        Entry("backend.plda_score_matrix",
              backend.plda_score_matrix,
              (plda, ivecs, ivecs), (None, None, None)),
        Entry("backend.plda_score_pairs",
              backend.plda_score_pairs,
              (plda, ivecs, ivecs), (None, None, None)),
    ]
