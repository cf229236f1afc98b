from repro_torch.configs.base import (ALL_SHAPES, ARCH_IDS, DECODE_32K,
                                     LONG_500K, PORTED_ARCH_IDS, PREFILL_32K,
                                     TRAIN_4K, ShapeConfig, ModelConfig,
                                     MoEConfig, SSMConfig, get_config,
                                     get_shape)
from repro_torch.configs.ivector_tvm import CONFIG, SMOKE, IVectorConfig

__all__ = ["ALL_SHAPES", "ARCH_IDS", "CONFIG", "DECODE_32K", "LONG_500K",
           "PORTED_ARCH_IDS", "PREFILL_32K", "SMOKE", "TRAIN_4K",
           "IVectorConfig", "ShapeConfig", "ModelConfig", "MoEConfig",
           "SSMConfig", "get_config", "get_shape"]
