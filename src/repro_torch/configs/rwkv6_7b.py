"""RWKV-6 (Finch) 7B [arXiv:2404.05892]: attention-free, data-dependent decay.

Sub-quadratic: runs the long_500k cell (recurrent state, O(1) per decoded token).

A copy of ``repro/configs/rwkv6_7b.py``.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # wkv heads of head_dim=64
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    mlp_variant="relu2",  # rwkv channel-mix uses squared relu
    norm="layernorm",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, tokenshift_lora=32),
    subquadratic=True,
    grad_accum=4,  # seq can't shard over 'model' (recurrence) -> bound saves
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64, d_ff=256,
    vocab_size=512, rwkv=RWKVConfig(head_dim=64, decay_lora=16, tokenshift_lora=8),
    param_dtype="float32", activation_dtype="float32", grad_accum=1,
)
