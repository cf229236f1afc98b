from repro_torch.configs.base import (ShapeConfig, ModelConfig, MoEConfig,
                                     SSMConfig, get_config)
from repro_torch.configs.ivector_tvm import CONFIG, SMOKE, IVectorConfig

__all__ = ["CONFIG", "SMOKE", "IVectorConfig", "ShapeConfig", "ModelConfig",
           "MoEConfig", "SSMConfig", "get_config"]
