"""InternVL2-1B [arXiv:2404.16821]: Qwen2-0.5B-style LM backbone + ViT stub.

The InternViT frontend is a STUB per the brief: ``input_specs()`` supplies
precomputed patch embeddings [B, 256, d_model] which are prepended to the
text-token embeddings.

A copy of ``repro/configs/internvl2_1b.py``.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    mlp_variant="swiglu",
    norm="rmsnorm",
    rope_theta=1000000.0,
    encoder=EncoderConfig(n_layers=0, n_frames=256, frontend_dim=896),
    note="patch embeddings prepended to text; n_frames=256 image patches",
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
    encoder=EncoderConfig(n_layers=0, n_frames=16, frontend_dim=128),
    param_dtype="float32", activation_dtype="float32", attn_chunk=64,
)
