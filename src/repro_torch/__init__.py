"""PyTorch + CUDA port of the i-vector system in ``repro``.

Each module mirrors its counterpart in the JAX package one to one
(``repro/core/ubm.py`` -> ``repro_torch/core/ubm.py``). The package imports
``torch`` and numpy only; the hand-written Hopper kernels live under
``csrc/`` and are built by ``kernels/_build.py`` at first use.

Entry points put their tensors on ``cuda`` unless the caller passes
``device="cpu"``; ``resolve_device`` is the one place that decides.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point works on: ``cuda`` unless the caller
    names another. Asking for CUDA without a card raises instead of
    carrying on silently on the CPU.

    Also pins float32 matrix products to full float32: the reference
    computes in f32 throughout, and TF32 (about three decimal digits)
    would be a different function. Both switches are process-wide torch
    settings; the port never turns them back on.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
