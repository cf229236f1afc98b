"""Baum-Welch statistics (the port of ``repro/core/stats.py``).

For utterance u with frames x_t and posteriors gamma_tc:
    n_c  = sum_t gamma_tc                  (occupancy, zeroth order)
    f_c  = sum_t gamma_tc x_t              (first order)
    S_c  = sum_t gamma_tc x_t x_t^T        (second order)

The STANDARD formulation centres f and S around the UBM means; the
AUGMENTED (Kaldi) formulation uses raw statistics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops

f32 = torch.float32


class BWStats(NamedTuple):
    n: torch.Tensor   # [U, C]
    f: torch.Tensor   # [U, C, D]
    S: Optional[torch.Tensor] = None  # [C, D, D] (summed over utts)


def scatter_accumulate(x, values, indices, n_utts: int, C: int,
                       second_order: Optional[str] = None, mask=None):
    """THE Baum-Welch accumulation: flat frames -> (n, f, S).

    x: [N, D] frames of ``n_utts`` equal-length utterances laid end to end
    (utterance u owns rows [u*N/n_utts, (u+1)*N/n_utts) -- the
    ``repeat(arange(u), F)`` utterance ids every caller of the JAX
    function passes); values/indices: [N, K] sparse posteriors; mask: [N]
    optional validity. ``second_order``: None | 'diag' | 'full' selects S
    as absent, [C, D] (sum gamma x^2) or [C, D*D] (sum gamma vec(x x^T),
    row-major).

    Deterministic on the card: the JAX function scatter-adds, and
    ``index_add_`` on CUDA accumulates with float atomics in an order
    that changes from run to run. Here the K slots are written into a
    dense [N, C] posterior matrix one slot at a time (each call puts at
    most one value in each row, so no two additions ever meet), and the
    moments are reductions and matrix products over it, whose order is
    fixed. The same request therefore gives the same statistics bit for
    bit on every run. The full second moment comes from ``ops.bw_stats``
    (the ``bw_stats`` kernel on the card), which forms vec(x x^T) on chip
    instead of an [N, D*D] expansion in device memory.
    """
    N, D = x.shape
    if N % n_utts:
        raise ValueError(f"{N} frames do not split into {n_utts} "
                         "equal-length utterances")
    x = x.to(f32)
    values = values.to(f32)
    if mask is not None:
        # where, not multiply: NaN/inf in garbage padding frames must not
        # survive masking (NaN * 0 == NaN)
        valid = mask.bool()[:, None]
        zero = torch.zeros((), dtype=f32, device=x.device)
        values = torch.where(valid, values, zero)
        x = torch.where(valid, x, zero)
    gamma = torch.zeros((N, C), dtype=f32, device=x.device)
    for k in range(indices.shape[1]):
        gamma.scatter_add_(1, indices[:, k:k + 1], values[:, k:k + 1])
    g3 = gamma.reshape(n_utts, N // n_utts, C)
    n = g3.sum(dim=1)
    f = g3.transpose(1, 2) @ x.reshape(n_utts, N // n_utts, D)
    S = None
    if second_order == "diag":
        S = gamma.T @ (x * x)
    elif second_order == "full":
        S = ops.bw_stats(gamma, x)[2]
    return n, f, S


def center(stats: BWStats, means) -> BWStats:
    """Centre first/second-order stats around UBM means (standard form)."""
    f = stats.f - stats.n[..., None] * means[None]
    S = stats.S
    if S is not None:
        n_tot = stats.n.sum(dim=0)
        f_tot = stats.f.sum(dim=0)
        S = (S - f_tot[:, :, None] * means[:, None, :]
             - means[:, :, None] * f_tot[:, None, :]
             + n_tot[:, None, None] * means[:, :, None] * means[:, None, :])
    return BWStats(stats.n, f, S)
