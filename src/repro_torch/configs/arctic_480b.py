"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: every layer has a 128-expert top-2 MoE branch (expert
d_ff=4864) in parallel with a dense d_ff=4864 residual MLP. At 480B params
this is the memory-pressure stress case: bf16 Adam moments + full FSDPxTP
sharding of params and optimizer state.

A copy of ``repro/configs/arctic_480b.py``. One card serves 2 layers
(about 55 GB in bf16). Its train state shards over a mesh of ranks
(``sharding.make_rules``; the dry run lowers it on the production
meshes); one layer's state is past a card, so training it waits for a
host with more cards than one.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,  # dense residual branch
    vocab_size=32000,
    mlp_variant="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(
        n_experts=128,
        top_k=2,
        d_ff_expert=4864,
        capacity_factor=1.25,
        dense_residual_d_ff=4864,
        layout="all",
    ),
    opt_state_dtype="bfloat16",
    note="params+opt fully sharded over data*model (FSDP x TP); bf16 moments",
)

SMOKE = CONFIG.with_overrides(
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=128, capacity_factor=1.25,
                  dense_residual_d_ff=128, layout="all"),
    param_dtype="float32", activation_dtype="float32", attn_chunk=64,
)
