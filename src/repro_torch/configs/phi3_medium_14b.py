"""Phi-3-medium 14B [arXiv:2404.14219]: RoPE, SwiGLU, GQA (kv=10).

A copy of ``repro/configs/phi3_medium_14b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    mlp_variant="swiglu",
    norm="rmsnorm",
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", attn_chunk=64,
)
