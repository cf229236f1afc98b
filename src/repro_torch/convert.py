"""Carry trained parameters across from the JAX package.

The arguments are numpy arrays: ``np.asarray`` of the leaves of a JAX
``FullGMM`` (weights, means, covs), ``DiagGMM`` (weights, means, vars) or
``TVModel`` (T, Sigma, prior, means, formulation), ``BackendArtifact``
(mu, lda.mean, lda.proj, plda.mean, plda.B, plda.W, whitener), the flat
``{name: array}`` params of an LM (``repro.models.api.init_params``) or
an LM train state (``repro.models.api.init_state``). The
port then computes the same function as the JAX package on the same
parameters. Tensors go to ``device``: CUDA unless the caller names
another.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.artifacts import BackendArtifact
from repro_torch.core.backend import LDA, PLDA
from repro_torch.core.tvm import TVModel
from repro_torch.core.ubm import DiagGMM, FullGMM


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def ubm_from_numpy(weights, means, covs, device=None) -> FullGMM:
    """weights [C], means [C, D], covs [C, D, D] -> the port's FullGMM."""
    dev = resolve_device(device)
    return FullGMM(_tensor(weights, dev), _tensor(means, dev),
                   _tensor(covs, dev))


def diag_from_numpy(weights, means, vars_, device=None) -> DiagGMM:
    """weights [C], means [C, D], vars [C, D] -> the port's DiagGMM."""
    dev = resolve_device(device)
    return DiagGMM(_tensor(weights, dev), _tensor(means, dev),
                   _tensor(vars_, dev))


def tvm_from_numpy(T, Sigma, prior, means, formulation: str,
                   device=None) -> TVModel:
    """T [C, D, R], Sigma [C, D, D], prior [R], means [C, D] -> TVModel."""
    if formulation not in ("standard", "augmented"):
        raise ValueError(f"formulation must be 'standard'|'augmented', "
                         f"got {formulation!r}")
    dev = resolve_device(device)
    return TVModel(_tensor(T, dev), _tensor(Sigma, dev),
                   _tensor(prior, dev), _tensor(means, dev), formulation)


def backend_from_numpy(mu, lda_mean, lda_proj, plda_mean, B, W,
                       whitener=None, device=None):
    """The leaves of a JAX ``BackendArtifact`` -> the port's (mu [R], LDA
    mean [R] and proj [R, K], PLDA mean [K], B and W [K, K], whitener
    [R, R] or None)."""
    dev = resolve_device(device)
    return BackendArtifact(
        mu=_tensor(mu, dev), lda=LDA(_tensor(lda_mean, dev),
                                     _tensor(lda_proj, dev)),
        plda=PLDA(_tensor(plda_mean, dev), _tensor(B, dev), _tensor(W, dev)),
        whitener=None if whitener is None else _tensor(whitener, dev))


def lm_params_from_numpy(params, dtype, device=None):
    """{name: array} LM params (the JAX names and stacked layer axes) ->
    {name: tensor} in ``dtype`` (a torch dtype or its name, e.g.
    ``"float32"``). Arrays in bf16 widen to f32 exactly on the way."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), dtype=dt, device=dev)
            for k, v in params.items()}


def lm_state_from_numpy(state, dtype, device=None):
    """An LM train state {'params', 'opt': {'m', 'v', 'count'}} of arrays
    (the JAX ``init_state`` or a JAX train step's output) -> the port's:
    params in ``dtype``, each moment in its array's own dtype (float32 or
    bfloat16), count an int32 scalar. Arrays in bf16 widen to f32 exactly
    on the way."""
    dev = resolve_device(device)
    opt = state["opt"]

    def moments(tree):
        return {k: lm_params_from_numpy({k: v}, str(np.asarray(v).dtype),
                                        dev)[k] for k, v in tree.items()}
    return {"params": lm_params_from_numpy(state["params"], dtype, dev),
            "opt": {"m": moments(opt["m"]), "v": moments(opt["v"]),
                    "count": torch.tensor(int(np.asarray(opt["count"])),
                                          dtype=torch.int32, device=dev)}}
