"""Gemma 2B [arXiv:2403.08295]: GeGLU, MQA (kv=1), head_dim=256, tied embeds.

A copy of ``repro/configs/gemma_2b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_variant="geglu",
    norm="rmsnorm",
    rope_theta=10000.0,
    tie_embeddings=True,
    note="MQA kv=1: decode KV cache sharded over sequence, not heads",
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256,
    vocab_size=512, param_dtype="float32", activation_dtype="float32",
    attn_chunk=64,
)
