"""Nemotron-4 15B [arXiv:2402.16819]: GQA (kv=8), squared-ReLU MLP.

A copy of ``repro/configs/nemotron_4_15b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_variant="relu2",
    norm="layernorm",
    rope_theta=10000.0,
    note="squared-ReLU MLP (ungated, single up-proj); 256k vocab -> sharded xent",
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab_size=512,
    param_dtype="float32", activation_dtype="float32", attn_chunk=64,
)
