"""Carry trained parameters across from the JAX package.

The arguments are numpy arrays: ``np.asarray`` of the leaves of a JAX
``FullGMM`` (weights, means, covs) or ``TVModel`` (T, Sigma, prior,
means, formulation). The port then computes the same function as the
JAX package on the same parameters. Tensors go to ``device``: CUDA unless
the caller names another.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.tvm import TVModel
from repro_torch.core.ubm import FullGMM


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def ubm_from_numpy(weights, means, covs, device=None) -> FullGMM:
    """weights [C], means [C, D], covs [C, D, D] -> the port's FullGMM."""
    dev = resolve_device(device)
    return FullGMM(_tensor(weights, dev), _tensor(means, dev),
                   _tensor(covs, dev))


def tvm_from_numpy(T, Sigma, prior, means, formulation: str,
                   device=None) -> TVModel:
    """T [C, D, R], Sigma [C, D, D], prior [R], means [C, D] -> TVModel."""
    if formulation not in ("standard", "augmented"):
        raise ValueError(f"formulation must be 'standard'|'augmented', "
                         f"got {formulation!r}")
    dev = resolve_device(device)
    return TVModel(_tensor(T, dev), _tensor(Sigma, dev),
                   _tensor(prior, dev), _tensor(means, dev), formulation)
