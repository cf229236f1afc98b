"""Decoder-only transformer with a KV cache: dense self-attention layers.

The port of ``repro/models/transformer.py`` for a dense FFN: training,
prefill and decode. Per-layer params keep the JAX names under
``"layer/"`` and their stacked leading [L] axis; the port loops over
layers in Python. With ``cfg.remat == "layer"`` a training forward
recomputes each layer in the backward pass (``torch.utils.checkpoint``,
the JAX ``jax.checkpoint`` of the layer body). A decode step writes the
new k and v into the cache in place and returns it.

Not ported yet (ROADMAP.md Queue 1 item 14): the MoE FFN (item 14d),
cross-attention and the learned ``pos_embed`` (whisper, item 14c) and the
ring-attention mesh path (item 14g).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L


def _require_dense(cfg) -> None:
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.arch_id} ({cfg.family}): the port's transformer runs "
            "dense self-attention decoders only; MoE layers are not "
            "ported yet (ROADMAP.md Queue 1 item 14)")


def decoder_table(cfg) -> L.ParamTable:
    _require_dense(cfg)
    nl = cfg.n_layers
    t: L.ParamTable = {}
    t.update(L.embed_table(cfg))
    t.update(L.attn_table(cfg, "layer/attn", nl))
    t.update(L.norm_table(cfg, "layer/ln_attn", nl))
    t.update(L.norm_table(cfg, "ln_final"))
    t.update(L.mlp_table(cfg, "layer/mlp", nl))
    t.update(L.norm_table(cfg, "layer/ln_mlp", nl))
    return t


def split_params(params) -> Tuple[Dict, Dict]:
    layer = {k[len("layer/"):]: v for k, v in params.items()
             if k.startswith("layer/")}
    other = {k: v for k, v in params.items() if not k.startswith("layer/")}
    return layer, other


def _sub(p, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


def _train_layer(cfg, lp, x, positions):
    """One layer of the training forward: attention, then the MLP, each
    pre-normed and added to the residual."""
    ap = _sub(lp, "attn/")
    q, k, v = L.qkv_proj(cfg, ap, L.norm(cfg, lp, "ln_attn", x), positions)
    x = x + L.out_proj(ap, L.blockwise_causal_attention(q, k, v)).to(x.dtype)
    return x + L.mlp(cfg, _sub(lp, "mlp/"),
                     L.norm(cfg, lp, "ln_mlp", x)).to(x.dtype)


def forward(cfg, params, x, kind: str, *, cache=None, pos=None):
    """Run the decoder stack.

    kind='train': x [B, S, D] embedded inputs; returns (hidden [B,S,D],
        None), each layer recomputed in the backward pass when
        ``cfg.remat == "layer"``.
    kind='prefill': x [B, S, D] embedded inputs; returns (hidden [B,S,D],
        cache {'k','v': [L, B, S, KVH, hd]}).
    kind='decode': x [B, 1, D]; ``cache`` {'k','v'} [L, B, S, KVH, hd],
        updated in place at ``pos``; returns (hidden [B,1,D], cache).
    (The JAX forward also returns the MoE router loss, 0 for a dense FFN.)
    """
    _require_dense(cfg)
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"kind {kind!r}: 'train', 'prefill' or 'decode'")
    layer_p, other_p = split_params(params)
    if kind == "train":
        positions = torch.arange(x.shape[1], device=x.device)
        for i in range(cfg.n_layers):
            lp = {k: v[i] for k, v in layer_p.items()}
            if cfg.remat == "layer":
                x = checkpoint(_train_layer, cfg, lp, x, positions,
                               use_reentrant=False)
            else:
                x = _train_layer(cfg, lp, x, positions)
        return L.norm(cfg, other_p, "ln_final", x), None
    dtype = x.dtype
    decode = kind == "decode"
    positions = (torch.full((1,), pos, dtype=torch.int32, device=x.device)
                 if decode else torch.arange(x.shape[1], device=x.device))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layer_p.items()}
        ap = _sub(lp, "attn/")
        hn = L.norm(cfg, lp, "ln_attn", x)
        q, k, v = L.qkv_proj(cfg, ap, hn, positions)
        if decode:
            kc, vc = cache["k"][i], cache["v"][i]
            kc[:, pos] = k[:, 0].to(kc.dtype)
            vc[:, pos] = v[:, 0].to(vc.dtype)
            o = L.decode_attention(q[:, 0], kc, vc, pos)[:, None]
        else:
            o = L.blockwise_causal_attention(q, k, v)
            ks.append(k)
            vs.append(v)
        x = x + L.out_proj(ap, o).to(dtype)
        x = x + L.mlp(cfg, _sub(lp, "mlp/"),
                      L.norm(cfg, lp, "ln_mlp", x)).to(dtype)
    x = L.norm(cfg, other_p, "ln_final", x)
    if not decode:
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, cache


def cache_struct(cfg, batch: int, seq: int, dtype):
    """{'k', 'v'}: (shape, dtype) of the decode KV cache."""
    KVH, hd, nl = cfg.n_kv_heads, cfg.resolved_head_dim(), cfg.n_layers
    return {"k": ((nl, batch, seq, KVH, hd), dtype),
            "v": ((nl, batch, seq, KVH, hd), dtype)}
