"""Serving: batched variable-length i-vector extraction."""
from repro_torch.serving.extractor import (IVectorExtractor, RequestInfo,
                                           ServingConfig)

__all__ = ["IVectorExtractor", "RequestInfo", "ServingConfig"]
