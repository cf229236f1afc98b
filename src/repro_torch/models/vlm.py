"""InternVL2-style VLM: stub ViT patch embeddings prepended to the text
stream of a GQA decoder LM. The loss is computed on text positions only.

The port of ``repro/models/vlm.py``. The InternViT frontend is a stub, as
in the reference: the caller supplies patch embeddings [B, n_patches,
frontend_dim], which ``patch_proj`` maps to the model width.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import tag


def vlm_table(cfg) -> L.ParamTable:
    t = T.decoder_table(cfg)
    fd = cfg.encoder.frontend_dim
    t["patch_proj"] = ((fd, cfg.d_model), (None, "dmodel"), ("normal", 0.02))
    return t


def _merge(cfg, params, patches, tokens):
    """[B, P + S, d]: the projected patches (an f32 sum rounded to the
    working type), then the text embeddings."""
    dtype = L.cfg_dtype(cfg)
    pe = L._f32_dot(patches.to(dtype), params["patch_proj"].to(dtype))
    te = L.embed(cfg, params, tokens)
    return tag(torch.cat([pe.to(dtype), te], dim=1), "batch", "seq", None)


def forward_train(cfg, params, patches, tokens):
    """-> (hidden states of the TEXT positions only [B, S_text, d],
    router aux loss)."""
    x = _merge(cfg, params, patches, tokens)
    h, aux, _ = T.forward(cfg, params, x, "train")
    return h[:, patches.shape[1]:], aux


def forward_prefill(cfg, params, patches, tokens):
    """-> (hidden [B, P + S, d], aux, cache over all P + S positions)."""
    return T.forward(cfg, params, _merge(cfg, params, patches, tokens),
                     "prefill")


def forward_decode(cfg, params, token, cache, pos: int):
    x = L.embed(cfg, params, token[:, None])
    return T.forward(cfg, params, x, "decode", cache=cache, pos=pos)
