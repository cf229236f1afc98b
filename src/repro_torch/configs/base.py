"""Config system of the LM side: shape and model dataclasses, arch registry.

A copy of ``repro/configs/base.py``: the port keeps its own so that it
imports nothing of the JAX package, and copies the sub-configs whole so
that ``ModelConfig`` keeps every field. ``get_config`` resolves every LM
arch id of ``ARCH_IDS`` (``PORTED_ARCH_IDS``: all ten); ``ivector-tvm``
is the i-vector config, ``configs.ivector_tvm``.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape. ``kind`` selects which step gets lowered."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; "
                   f"have {[s.name for s in ALL_SHAPES]}")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # arctic-style dense MLP residual running in parallel with the MoE branch
    dense_residual_d_ff: int = 0
    # which layers are MoE: 'all' | 'every_other' (odd layers, jamba-style)
    layout: str = "all"
    router_aux_loss: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective-SSM hyperparameters (jamba's SSM layers)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)
    # dtype of the scan's transition tensors, named as jnp.dtype reads it:
    # "float32", "bfloat16" or "float16" (kernels/ref.py, SCAN_DTYPES)
    scan_dtype: str = "float32"

    def __post_init__(self):
        if self.scan_dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"scan_dtype {self.scan_dtype!r}: 'float32', "
                             "'bfloat16' or 'float16'")


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    tokenshift_lora: int = 32


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder tower for enc-dec (whisper) / frontend for VLM (internvl)."""

    n_layers: int = 0
    n_frames: int = 0
    frontend_dim: int = 0
    is_causal: bool = False


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'audio' | 'vlm' | 'hybrid'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    mlp_variant: str = "swiglu"  # 'swiglu' | 'geglu' | 'relu2' | 'gelu'
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid (jamba): one attention layer every `attn_period` layers; others SSM
    attn_period: int = 0
    subquadratic: bool = False
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: str = "layer"
    grad_accum: int = 1
    attn_chunk: int = 1024
    note: str = ""

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def shape_applicability(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """(runnable, reason-if-skipped) for an assigned (arch x shape) cell."""
        if shape.name == "long_500k" and not self.subquadratic:
            return False, ("full quadratic attention; 512k decode cache "
                           "infeasible")
        return True, ""

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# every arch id of the JAX package, ported or not (names only: the
# dry-run reports a row for each; ``get_config`` resolves the ported ones)
ARCH_IDS = (
    "nemotron-4-15b",
    "phi3-medium-14b",
    "gemma-2b",
    "stablelm-1.6b",
    "arctic-480b",
    "moonshot-v1-16b-a3b",
    "rwkv6-7b",
    "whisper-large-v3",
    "internvl2-1b",
    "jamba-v0.1-52b",
    # the paper's own model, registered as an arch so it runs through the
    # same dry-run / roofline machinery (an extra row)
    "ivector-tvm",
)

PORTED_ARCH_IDS = ("stablelm-1.6b", "jamba-v0.1-52b", "phi3-medium-14b",
                   "nemotron-4-15b", "gemma-2b", "whisper-large-v3",
                   "internvl2-1b", "rwkv6-7b", "arctic-480b",
                   "moonshot-v1-16b-a3b")


def _module_for(arch_id: str) -> str:
    return ("repro_torch.configs."
            + arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    """Resolve an LM arch id to its ModelConfig (``SMOKE`` if asked)."""
    if arch_id not in PORTED_ARCH_IDS:
        raise KeyError(f"arch {arch_id!r} is not an LM arch of repro_torch; "
                       f"have: {PORTED_ARCH_IDS}")
    mod = importlib.import_module(_module_for(arch_id))
    return mod.SMOKE if smoke else mod.CONFIG
