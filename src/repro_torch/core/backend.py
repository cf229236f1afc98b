"""Scoring backend (the port of ``repro/core/backend.py``; so far only the
length-norm that every served i-vector goes through)."""
from __future__ import annotations

import torch


def length_norm(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-10)
