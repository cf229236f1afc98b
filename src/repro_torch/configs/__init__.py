from repro_torch.configs.ivector_tvm import CONFIG, SMOKE, IVectorConfig

__all__ = ["CONFIG", "SMOKE", "IVectorConfig"]
