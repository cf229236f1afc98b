"""Public kernel entry points: dispatch by the tensor's device.

A CUDA tensor launches the hand-written kernel (or raises: there is no
fallback). A CPU tensor takes the plain version in ``ref.py``. The
contracts are those of ``repro/kernels/ops.py``: ids are clipped into
[0, C), ragged F, C, U and P give exactly the unpadded result (the CUDA
kernels mask their ragged edges), and the E-step ``dtype`` knob casts the
inputs only, accumulating in f32 always.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gmm_loglik as _gl
from repro_torch.kernels import gmm_rescore as _gr
from repro_torch.kernels import ref
from repro_torch.kernels import tvm_estep as _te

f32 = torch.float32


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def gmm_loglik(x, const, lin, P_flat):
    """x: [F, D]; const: [C]; lin: [D, C]; P_flat: [C, D*D] -> [F, C]."""
    if _on_cuda(x):
        return _gl.gmm_loglik(x.to(f32).contiguous(), const.contiguous(),
                              lin.contiguous(), P_flat.contiguous())
    return ref.gmm_loglik(x, const, lin, P_flat)


def gmm_rescore(x, sel, const, lin, P_flat, pack=None):
    """Sparse top-K rescoring: loglik of only the selected components.

    x: [F, D]; sel: [F, K] component ids; const/lin/P_flat as in
    ``gmm_loglik``. ``pack`` optionally supplies the pre-built
    ``ref.rescore_pack`` rows (the serving session caches them). Ids are
    clipped into [0, C), so garbage preselections from masked frames can
    never read out of bounds.
    """
    C = const.shape[0]
    sel = sel.long().clamp(0, C - 1)
    if _on_cuda(x):
        A = ref.rescore_pack(const, lin, P_flat) if pack is None else pack
        return _gr.gmm_rescore(x.to(f32).contiguous(), sel.contiguous(),
                               A.contiguous())
    return ref.gmm_rescore(x, sel, const, lin, P_flat)


tri_inverse = ref.tri_inverse
pack_symmetric = ref.pack_symmetric
unpack_symmetric = ref.unpack_symmetric


def _estep_cast(a, b, dtype):
    """Mixed-precision knob for the packed E-step contractions: bf16
    INPUTS, f32 accumulation in both the kernel and the plain version."""
    if dtype in ("bfloat16", "bf16"):
        return a.to(torch.bfloat16), b.to(torch.bfloat16)
    if dtype not in ("float32", "f32"):
        raise ValueError(
            f"estep dtype must be 'float32'|'bfloat16', got {dtype!r}")
    return a.to(f32), b.to(f32)


def tvm_estep_l(n, U_packed, *, dtype: str = "float32"):
    """Packed L-assembly: n [U, C] @ U_packed [C, P] -> [U, P] f32."""
    n, U_packed = _estep_cast(n, U_packed, dtype)
    if _on_cuda(n):
        return _te.tvm_estep_l(n.contiguous(), U_packed.contiguous())
    return ref.tvm_estep_l(n, U_packed)


def tvm_estep_a(n, PP_packed, *, dtype: str = "float32"):
    """Packed A-accumulation: nᵀ [C, U] @ PP_packed [U, P] -> [C, P] f32."""
    n, PP_packed = _estep_cast(n, PP_packed, dtype)
    if _on_cuda(n):
        return _te.tvm_estep_a(n.contiguous(), PP_packed.contiguous())
    return ref.tvm_estep_a(n, PP_packed)
