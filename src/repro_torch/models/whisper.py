"""Whisper large-v3 backbone: transformer encoder + cross-attending decoder.

The port of ``repro/models/whisper.py``. The mel-spectrogram conv
frontend is a stub, as in the reference: the caller supplies post-conv
frame embeddings [B, n_frames, frontend_dim]. The encoder's attention is
``layers.full_attention`` (non-causal, plain matmul and softmax, as the
reference's einsum); the decoder is ``transformer.forward`` with
cross-attention and a learned positional table, its causal
self-attention on the flash-attention kernel.
"""
from __future__ import annotations


from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import tag


def whisper_table(cfg, max_seq: int) -> L.ParamTable:
    enc = cfg.encoder
    t = T.decoder_table(cfg, max_seq=max_seq, cross=True)
    ne = enc.n_layers
    t.update(L.attn_table(cfg, "enc_layer/attn", ne))
    t.update(L.norm_table(cfg, "enc_layer/ln_attn", ne))
    t.update(L.mlp_table(cfg, "enc_layer/mlp", ne))
    t.update(L.norm_table(cfg, "enc_layer/ln_mlp", ne))
    t.update(L.norm_table(cfg, "enc_ln_final"))
    t["enc_pos_embed"] = ((enc.n_frames, cfg.d_model), (None, "dmodel"),
                          ("normal", 0.02))
    return t


def _enc_layer(cfg, lp, h):
    """One encoder layer: non-causal attention, then the MLP. The q, k, v
    products are summed in f32 and rounded to the working type, as the
    reference's ``preferred_element_type=f32`` einsums."""
    dtype = h.dtype
    hn = L.norm(cfg, lp, "ln_attn", h)
    q, k, v = (L._f32_proj_heads(hn, lp[f"attn/{w}"]).to(dtype)
               for w in ("wq", "wk", "wv"))
    o = L.full_attention(q, k, v, causal=False)
    h = h + L.out_proj({"wo": lp["attn/wo"]}, o).to(dtype)
    h = h + L.mlp(cfg, T._sub(lp, "mlp/"),
                  L.norm(cfg, lp, "ln_mlp", h)).to(dtype)
    return tag(h, "batch", "frames", None)


def encode(cfg, params, frames):
    """frames: [B, F, d] stub conv-frontend output -> [B, F, d] in the
    config's activation dtype."""
    enc_p = {k[len("enc_layer/"):]: v for k, v in params.items()
             if k.startswith("enc_layer/")}
    dtype = L.cfg_dtype(cfg)
    x = frames.to(dtype) + params["enc_pos_embed"].to(dtype)[None]
    x = tag(x, "batch", "frames", None)
    for i in range(cfg.encoder.n_layers):
        lp = {k: v[i] for k, v in enc_p.items()}
        if cfg.remat == "layer":
            x = L.remat(_enc_layer, cfg, lp, x)
        else:
            x = _enc_layer(cfg, lp, x)
    return L.layernorm(x, params["enc_ln_final/scale"],
                       params["enc_ln_final/bias"])


def _dec_params(params):
    return {k: v for k, v in params.items()
            if not k.startswith(("enc_layer/", "enc_pos_embed",
                                 "enc_ln_final"))}


def forward_train(cfg, params, frames, tokens):
    """-> (hidden [B, S, d] of the decoder over ``tokens``, router aux
    loss)."""
    enc_out = encode(cfg, params, frames)
    x = L.embed(cfg, params, tokens)
    h, aux, _ = T.forward(cfg, _dec_params(params), x, "train",
                          enc_out=enc_out)
    return h, aux


def forward_prefill(cfg, params, frames, tokens):
    """-> (hidden [B, S, d], aux, cache {'k', 'v', 'xk', 'xv'})."""
    enc_out = encode(cfg, params, frames)
    x = L.embed(cfg, params, tokens)
    return T.forward(cfg, _dec_params(params), x, "prefill", enc_out=enc_out)


def forward_decode(cfg, params, token, cache, pos: int):
    """token [B] at ``pos`` -> (hidden [B, 1, d], aux, cache updated in
    place)."""
    x = L.embed(cfg, params, token[:, None])
    return T.forward(cfg, _dec_params(params), x, "decode", cache=cache,
                     pos=pos)
