"""Moonlight 16B-A3B [hf:moonshotai/Moonlight-16B-A3B]: 64-expert top-6 MoE.

A copy of ``repro/configs/moonshot_v1_16b_a3b.py``. One card serves
it at full depth (about 56 GB in bf16) and trains 4 of its layers.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert
    vocab_size=163840,
    mlp_variant="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  capacity_factor=1.25, layout="all"),
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=8, d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=128, capacity_factor=1.25,
                  layout="all"),
    param_dtype="float32", activation_dtype="float32", attn_chunk=64,
)
