"""Jamba v0.1 52B [arXiv:2403.19887]: Mamba+attention 1:7 interleave, MoE.

Layer i is attention iff i % 8 == 0 (1 attn : 7 mamba); layer i has a
16-expert top-2 MoE FFN iff i % 2 == 1, dense d_ff=14336 otherwise.

A copy of ``repro/configs/jamba_v0_1_52b.py``. One card holds one
period (8 layers) with its experts for serving. Its train state shards
over a mesh of ranks (``sharding.make_rules``); one period's state with
experts is past a card, so training it waits for a host with more cards
than one.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    mlp_variant="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336,
                  capacity_factor=1.25, layout="every_other"),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    attn_period=8,
    subquadratic=True,
    grad_accum=4,
)

SMOKE = CONFIG.with_overrides(
    n_layers=8, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256, vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256, capacity_factor=1.25,
                  layout="every_other"),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    attn_period=8,
    param_dtype="float32", activation_dtype="float32", attn_chunk=64,
    grad_accum=1,
)
