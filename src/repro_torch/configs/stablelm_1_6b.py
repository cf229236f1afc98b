"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b]: MHA (kv=32), SwiGLU.

A copy of ``repro/configs/stablelm_1_6b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    mlp_variant="swiglu",
    norm="layernorm",
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=8, d_ff=256, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", attn_chunk=64,
)
