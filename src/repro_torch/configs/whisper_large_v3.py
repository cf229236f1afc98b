"""Whisper large-v3 [arXiv:2212.04356]: enc-dec transformer backbone.

The conv frontend is a STUB per the brief: ``input_specs()`` supplies
precomputed post-conv frame embeddings [B, 1500, d_model]. The assigned
shapes drive the DECODER sequence length; the encoder is fixed at 1500
frames (30 s of audio at 50 fps after the 2x conv subsampling).

A copy of ``repro/configs/whisper_large_v3.py``.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    n_layers=32,  # decoder layers; encoder tower configured below
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    mlp_variant="gelu",
    norm="layernorm",
    encoder=EncoderConfig(n_layers=32, n_frames=1500, frontend_dim=1280),
    note="enc-dec; sinusoidal->learned pos emb simplified to learned; "
         "assigned seq_len applies to the decoder token stream",
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
    encoder=EncoderConfig(n_layers=2, n_frames=64, frontend_dim=128),
    param_dtype="float32", activation_dtype="float32", attn_chunk=64,
)
