"""Public kernel entry points: dispatch by the tensor's device.

A CUDA tensor launches the hand-written kernel (or raises: there is no
fallback). A CPU tensor takes the plain version in ``ref.py``, and so does
a meta tensor (shapes only: a lowered call, ``launch/dryrun.py``), but for
the two LM kernels, whose meta calls take the card's path (the autograd
functions, their backward a kernel region too) with outputs of the
kernels' shapes and nothing computed: a lowered train step then counts
what the card runs, not the plain version's S x S scores. Where a
gradient is wanted, ``flash_attention`` and ``selective_scan`` on CUDA
tensors are ``torch.autograd.Function``s whose backward is a hand-written
kernel too (``flash_attention_bwd``, ``selective_scan_bwd``); on the CPU
autograd differentiates the plain version. The
contracts are those of ``repro/kernels/ops.py``: ids are clipped into
[0, C), ragged F, C, U and P give exactly the unpadded result (the CUDA
kernels mask their ragged edges), and the E-step ``dtype`` knob casts the
inputs only, accumulating in f32 always.

Each dispatch function is a ``kernel_region`` (``analysis/op_cost.py``):
a counter on counts the registry's work for the call's shapes, on either
device, instead of the plain version's ops; the ``_cfg_*`` functions give
those shapes (a meta call's ids give a bound, ``_rows_touched``).
"""
from __future__ import annotations

import torch

from repro_torch.analysis.op_cost import kernel_region
from repro_torch.kernels import bw_stats as _bw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gmm_align as _ga
from repro_torch.kernels import gmm_loglik as _gl
from repro_torch.kernels import gmm_rescore as _gr
from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan as _ss
from repro_torch.kernels import tvm_estep as _te

f32 = torch.float32


def _rows_touched(sel, C: int) -> dict:
    """The distinct component rows the ids ``sel`` touch, for a region's
    config. Meta ids hold no values: they give the bound min(C, F·K), the
    most rows the call can touch, marked ``rows_bound``."""
    if sel.is_meta:
        return {"rows_touched": min(C, sel.numel()), "rows_bound": True}
    return {"rows_touched": int(torch.unique(sel.clamp(0, C - 1)).numel())}


def _wants_grad(*tensors) -> bool:
    """Whether autograd will want the gradient of a call on ``tensors``:
    then the LM kernels go through their autograd functions."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _cfg_loglik(out, x, const, lin, P_flat):
    return {"F": x.shape[0], "C": const.shape[0], "D": x.shape[1]}


def _cfg_rescore(out, x, sel, const, lin, P_flat, pack=None):
    C = const.shape[0]
    return {"F": x.shape[0], "K": sel.shape[1], "C": C, "D": x.shape[1],
            **_rows_touched(sel, C)}


def _cfg_fused(out, x, sel, A2):
    C = A2.shape[0]
    return {"F": x.shape[0], "K": sel.shape[1], "C": C, "D": x.shape[1],
            "rescore_only": True, **_rows_touched(sel, C)}


def _cfg_align(out, x, dconst, dlin, dquad, A2, *, top_k: int):
    C = A2.shape[0]
    return {"F": x.shape[0], "K": top_k, "C": C, "D": x.shape[1],
            **_rows_touched(out[1], C)}


def _cfg_bw(out, gamma, x):
    return {"F": x.shape[0], "C": gamma.shape[1], "D": x.shape[1]}


def _estep_dtype(dtype: str) -> str:
    return "bfloat16" if dtype in ("bfloat16", "bf16") else "float32"


def _cfg_estep_l(out, n, U_packed, *, dtype: str = "float32"):
    return {"M": n.shape[0], "K": n.shape[1], "N": U_packed.shape[1],
            "dtype": _estep_dtype(dtype)}


def _cfg_estep_a(out, n, PP_packed, *, dtype: str = "float32"):
    return {"M": n.shape[1], "K": n.shape[0], "N": PP_packed.shape[1],
            "dtype": _estep_dtype(dtype)}


def _cfg_attention(out, q, k, v):
    B, S, H, hd = q.shape
    return {"B": B, "S": S, "H": H, "KVH": k.shape[2], "hd": hd,
            "dtype": str(q.dtype).removeprefix("torch."),
            "lse": _wants_grad(q, k, v)}


def _cfg_attention_bwd(out, q, k, v, o, lse, do):
    return {**_cfg_attention(out, q, k, v), "lse": True}


def _cfg_scan(out, dt, dx, A, Bc, Cc, h0=None, scan_dtype="float32"):
    B, T, di = dt.shape
    return {"B": B, "T": T, "di": di, "ds": A.shape[1],
            "h0": h0 is not None,
            "save_states": _wants_grad(dt, dx, A, Bc, Cc),
            "scan_dtype": scan_dtype}


def _cfg_scan_bwd(out, dt, dx, A, Bc, Cc, hs, dy, dh_last=None,
                  want_dh0=False, scan_dtype="float32"):
    B, T, di = dt.shape
    return {"B": B, "T": T, "di": di, "ds": A.shape[1],
            "dh_last": dh_last is not None, "dh0": want_dh0,
            "scan_dtype": scan_dtype}


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _no_dtensor(name: str, *ts) -> None:
    """A kernel takes a rank's local tensors: a DTensor here means a mesh
    path that forgot its ``local_map`` (its pointer is one shard's)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in ts):
        raise TypeError(f"{name}: got a DTensor; a kernel runs on each "
                        "rank's local block, under local_map "
                        "(models/layers.py)")


@kernel_region("gmm_loglik", _cfg_loglik)
def gmm_loglik(x, const, lin, P_flat):
    """x: [F, D]; const: [C]; lin: [D, C]; P_flat: [C, D*D] -> [F, C]."""
    if _on_cuda(x):
        return _gl.gmm_loglik(x.to(f32).contiguous(), const.contiguous(),
                              lin.contiguous(), P_flat.contiguous())
    return ref.gmm_loglik(x, const, lin, P_flat)


@kernel_region("gmm_rescore", _cfg_rescore)
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


@kernel_region("gmm_rescore_fused", _cfg_fused, kernel="gmm_align")
def gmm_rescore_fused(x, sel, A2):
    """Selected-set log-likelihoods through the packed-symmetric
    ``ref.align_pack`` rows A2 [C, E2]: x [F, D], sel [F, K] -> [F, K].
    Ids are clipped into [0, C), as in ``gmm_rescore``."""
    sel = sel.long().clamp(0, A2.shape[0] - 1)
    if _on_cuda(x):
        return _ga.gmm_rescore_fused(x.to(f32).contiguous(),
                                     sel.contiguous(), A2.contiguous())
    return ref.gmm_rescore_fused(x, sel, A2)


@kernel_region("gmm_align", _cfg_align)
def gmm_align(x, dconst, dlin, dquad, A2, *, top_k: int):
    """The fused alignment front half: diag preselect + top-K + packed
    rescore -> (sel_ll [F, K] f32, sel [F, K] int64). dconst: [C]; dlin,
    dquad: [D, C] (``ubm.diag_coeffs``); A2: [C, E2] (``ref.align_pack``).
    Ties in the diag scores go to the lowest id on both paths."""
    if _on_cuda(x):
        return _ga.gmm_align(x.to(f32).contiguous(), dconst.contiguous(),
                             dlin.contiguous(), dquad.contiguous(),
                             A2.contiguous(), top_k)
    return ref.gmm_align(x, dconst, dlin, dquad, A2, top_k)


@kernel_region("bw_stats", _cfg_bw)
def bw_stats(gamma, x):
    """Dense Baum-Welch moments: gamma [F, C], x [F, D] ->
    (n [C], f [C, D], S [C, D*D]), all f32."""
    if _on_cuda(x):
        return _bw.bw_stats(gamma.to(f32).contiguous(),
                            x.to(f32).contiguous())
    return ref.bw_stats(gamma, x)


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


@kernel_region("tvm_estep_l", _cfg_estep_l, kernel="tvm_estep")
def tvm_estep_l(n, U_packed, *, dtype: str = "float32"):
    """Packed L-assembly: n [U, C] @ U_packed [C, P] -> [U, P] f32."""
    n, U_packed = _estep_cast(n, U_packed, dtype)
    if _on_cuda(n):
        return _te.tvm_estep_l(n.contiguous(), U_packed.contiguous())
    return ref.tvm_estep_l(n, U_packed)


@kernel_region("tvm_estep_a", _cfg_estep_a, kernel="tvm_estep")
def tvm_estep_a(n, PP_packed, *, dtype: str = "float32"):
    """Packed A-accumulation: nᵀ [C, U] @ PP_packed [U, P] -> [C, P] f32."""
    n, PP_packed = _estep_cast(n, PP_packed, dtype)
    if _on_cuda(n):
        return _te.tvm_estep_a(n.contiguous(), PP_packed.contiguous())
    return ref.tvm_estep_a(n, PP_packed)


def _fa_kernel(q, k, v, lse: bool = False):
    """The attention kernel, or on meta tensors its outputs' shapes."""
    if not q.is_meta:
        return _fa.flash_attention(q, k, v, lse=lse)
    B, S, H, _ = q.shape
    o = torch.empty_like(q)
    return (o, q.new_empty((B, H, S), dtype=f32)) if lse else o


def _ss_kernel(dt, dx, A, Bc, Cc, h0, save_states: bool = False,
               scan_dtype: str = "float32"):
    """The scan kernel, or on meta tensors its outputs' shapes."""
    if not dt.is_meta:
        return _ss.selective_scan(dt, dx, A, Bc, Cc, h0,
                                  save_states=save_states,
                                  scan_dtype=scan_dtype)
    B, T, di = dt.shape
    ds = A.shape[1]
    y, h = dt.new_empty((B, T, di)), dt.new_empty((B, di, ds))
    if not save_states:
        return y, h
    return y, h, dt.new_empty((B, _ss.n_chunks(T), di, ds))


class _FlashAttention(torch.autograd.Function):
    """Kernel forward (with the rows' log-sum-exp), kernel backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _fa_kernel(q, k, v, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd(*ctx.saved_tensors, do.contiguous())


@kernel_region("flash_attention", _cfg_attention)
def flash_attention(q, k, v):
    """Causal GQA attention, forward: q [B, S, H, hd], k, v [B, S, KVH, hd]
    -> [B, S, H, hd] in q's dtype. Any S; both paths keep the scores in
    f32 and p to f32 precision (the bf16 kernel as a hi and lo bf16 pair;
    ``repro/models/layers.py``'s blockwise path casts p to q's dtype
    before P.V; at bf16 the port follows the TPU kernel). Differentiable:
    on the card through ``flash_attention_bwd``."""
    _no_dtensor("flash_attention", q, k, v)
    if _on_cuda(q) or q.is_meta:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if _wants_grad(q, k, v):
            return _FlashAttention.apply(q, k, v)
        return _fa_kernel(q, k, v)
    return ref.flash_attention(q, k, v)


@kernel_region("flash_attention_bwd", _cfg_attention_bwd)
def flash_attention_bwd(q, k, v, o, lse, do):
    """The gradients (dq, dk, dv) of ``flash_attention`` from its inputs,
    output o, row log-sum-exps lse [B, H, S] f32 and the output's
    gradient do; CUDA tensors only (the CPU path is autograd of the plain
    version)."""
    _no_dtensor("flash_attention_bwd", q, k, v, o, lse, do)
    if q.is_meta:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return _fa.flash_attention_bwd(q, k, v, o, lse, do)


class _SelectiveScan(torch.autograd.Function):
    """Kernel forward (saving each chunk's start state), kernel backward."""

    @staticmethod
    def forward(ctx, dt, dx, A, Bc, Cc, h0, scan_dtype):
        y, h_last, hs = _ss_kernel(dt, dx, A, Bc, Cc, h0, save_states=True,
                                   scan_dtype=scan_dtype)
        ctx.save_for_backward(dt, dx, A, Bc, Cc, hs)
        ctx.with_h0 = h0 is not None
        ctx.scan_dtype = scan_dtype
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        saved = ctx.saved_tensors      # unpacked once: remat allows no more
        dy = torch.zeros_like(saved[0]) if dy is None else dy.contiguous()
        if dh_last is not None:
            dh_last = dh_last.contiguous()
        ddt, ddx, dA, dB, dC, dh0 = selective_scan_bwd(
            *saved, dy, dh_last,
            want_dh0=ctx.with_h0 and ctx.needs_input_grad[5],
            scan_dtype=ctx.scan_dtype)
        return ddt, ddx, dA, dB, dC, dh0, None


@kernel_region("selective_scan", _cfg_scan)
def selective_scan(dt, dx, A, Bc, Cc, h0=None, scan_dtype="float32"):
    """The Mamba recurrence h_t = exp(dt_t A) h_{t-1} + dx_t B_t,
    y_t = C_t . h_t: dt, dx [B, T, di]; A [di, ds]; Bc, Cc [B, T, ds];
    h0 [B, di, ds] or None (zeros) -> (y [B, T, di], h_last [B, di, ds]),
    f32. ``scan_dtype`` "float32" runs it in f32; "bfloat16" and
    "float16" as the reference's chunked tree with its transitions
    rounded to that type (``ref.selective_scan_tree``). Differentiable: on
    the card through ``selective_scan_bwd``."""
    _no_dtensor("selective_scan", dt, dx, A, Bc, Cc, h0)
    ref.scan_type(scan_dtype)            # raises on other names
    if _on_cuda(dt) or dt.is_meta:
        dt, dx, A, Bc, Cc = (t.to(f32).contiguous()
                             for t in (dt, dx, A, Bc, Cc))
        if h0 is not None:
            h0 = h0.to(f32).contiguous()
        if _wants_grad(dt, dx, A, Bc, Cc, *(() if h0 is None else (h0,))):
            return _SelectiveScan.apply(dt, dx, A, Bc, Cc, h0, scan_dtype)
        return _ss_kernel(dt, dx, A, Bc, Cc, h0, scan_dtype=scan_dtype)
    return ref.selective_scan(dt, dx, A, Bc, Cc, h0, scan_dtype)


@kernel_region("selective_scan_bwd", _cfg_scan_bwd)
def selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh_last=None,
                       want_dh0=False, scan_dtype="float32"):
    """The gradients (d(dt), d(dx), dA, dB, dC, dh0 or None) of
    ``selective_scan`` from its inputs, the chunk start states hs its
    forward saved, dy and dh_last (or None); CUDA tensors only (the CPU
    path is autograd of the plain version)."""
    _no_dtensor("selective_scan_bwd", dt, dx, A, Bc, Cc, hs, dy, dh_last)
    if dt.is_meta:
        return tuple(torch.empty_like(t) for t in (dt, dx, A, Bc, Cc)) + (
            hs.new_empty(hs.shape[:1] + hs.shape[2:]) if want_dh0 else None,)
    return _ss.selective_scan_bwd(dt, dx, A, Bc, Cc, hs, dy, dh_last,
                                  want_dh0, scan_dtype)
