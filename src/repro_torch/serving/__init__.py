"""Serving: batched variable-length extraction with input validation,
admission control, runtime degradation, crash-safe streaming sessions, and
zero-downtime bundle rollout."""
from repro_torch.serving.extractor import (IVectorExtractor, RequestInfo,
                                           ServingConfig)
from repro_torch.serving.guard import AdmissionQueue, QueueFull, RequestResult
from repro_torch.serving.rollout import RolloutController, RolloutReport
from repro_torch.serving.session import (ChunkInfo, SessionConfig,
                                         SessionJournal, SessionStore,
                                         StreamSession)

__all__ = ["AdmissionQueue", "ChunkInfo", "IVectorExtractor", "QueueFull",
           "RequestInfo", "RequestResult", "RolloutController",
           "RolloutReport", "ServingConfig", "SessionConfig",
           "SessionJournal", "SessionStore", "StreamSession"]
