"""Plain PyTorch versions of the kernels (the port of ``repro/kernels/ref.py``).

They run the CPU path and are what ``chip_smoke.py`` holds each CUDA
kernel against on the card. Every product accumulates in float32; bf16
inputs are widened first, which is exact, so only the summation order
differs from a kernel that widens per element.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def _expand(x):
    """[F, D] -> [F, D*D] row-major vec(x x^T)."""
    F, D = x.shape
    return (x[:, :, None] * x[:, None, :]).reshape(F, D * D)


def gmm_loglik(x, const, lin, P_flat):
    """Full-covariance GMM log-likelihood via the vec-trick.

    x: [F, D]; const: [C]; lin: [D, C]; P_flat: [C, D*D] (row-major
    precision matrices). Returns [F, C]:
        out[f,c] = const[c] + x_f . lin[:,c] - 0.5 vec(x x^T) . P_flat[c]
    """
    x = x.to(f32)
    return const[None] + x @ lin - 0.5 * (_expand(x) @ P_flat.T)


def gmm_rescore(x, sel, const, lin, P_flat):
    """Loglik of the SELECTED components only.

    x: [F, D]; sel: [F, K] component ids in [0, C); const: [C]; lin:
    [D, C]; P_flat: [C, D*D]. Returns [F, K]:

        out[f, k] = const[sel[f,k]] + x_f . lin[:, sel[f,k]]
                    - 0.5 vec(x_f x_f^T) . P_flat[sel[f,k]]

    Duplicate indices are allowed (each slot scores independently).
    """
    x = x.to(f32)
    lin_g = lin.T[sel]                                     # [F, K, D]
    P_g = P_flat[sel]                                      # [F, K, D*D]
    return (const[sel]
            + torch.einsum("fd,fkd->fk", x, lin_g)
            - 0.5 * torch.einsum("fe,fke->fk", _expand(x), P_g))


def rescore_pack(const, lin, P_flat):
    """One gatherable row per component:
    A[c] = [const_c | lin[:, c] | P_flat[c]], shape [C, 1 + D + D*D]."""
    return torch.cat([const[:, None], lin.T, P_flat], dim=1).to(f32)


def _quad_pairs(D: int, device=None):
    """Upper-triangle pair indices and off-diagonal doubling weights of the
    packed quadratic form: (i0, i1, w) with w = 2 off the diagonal and 1 on
    it, so that vec(x x^T) . vec(P) == sum_p w_p x_{i0_p} x_{i1_p} P_{i0 i1}."""
    i0, i1 = torch.triu_indices(D, D, device=device)
    w = torch.where(i0 == i1, 1.0, 2.0).to(f32)
    return i0, i1, w


def align_pack(const, lin, P_flat):
    """Packed-symmetric rows of the fused alignment path:
    A2[c] = [const_c | lin[:, c] | -0.5 triu(P_c)], shape [C, E2] with
    E2 = 1 + D + D(D+1)/2 (the -0.5 of the quadratic term folded in)."""
    D = lin.shape[0]
    i0, i1, _ = _quad_pairs(D, P_flat.device)
    Pp = P_flat[:, i0 * D + i1]                              # [C, D(D+1)/2]
    return torch.cat([const[:, None], lin.T, -0.5 * Pp], dim=1).to(f32)


def expand_quadratic(x):
    """[F, D] -> [F, E2] packed-symmetric frame expansion
    xe[f] = [1 | x_f | w ⊙ (x_{i0} x_{i1})], so that ``xe @ align_pack^T``
    is the full-covariance log-likelihood."""
    F, D = x.shape
    x = x.to(f32)
    i0, i1, w = _quad_pairs(D, x.device)
    x2p = x[:, i0] * x[:, i1] * w[None]
    return torch.cat([torch.ones((F, 1), dtype=f32, device=x.device), x,
                      x2p], dim=1)


def gmm_rescore_fused(x, sel, A2):
    """Selected-set log-likelihoods [F, K] through the packed-symmetric
    rows: one [F, E2] @ [E2, C] product and a gather (the JAX oracle's
    ``strategy='full'``). sel: [F, K] ids in [0, C); A2: [C, E2]."""
    ll = expand_quadratic(x) @ A2.T                          # [F, C]
    return torch.gather(ll, 1, sel.long())


def topk_lowest(values, top_k: int):
    """Positions [F, K] (int64) of the top-K of each row of ``values``,
    ties toward the lowest position as ``lax.top_k`` breaks them: a stable
    descending sort keeps equal values in position order (``torch.topk``
    promises no order among equal values)."""
    order = torch.sort(values, dim=1, descending=True, stable=True).indices
    return order[:, :top_k]


def diag_topk(x, dconst, dlin, dquad, top_k: int):
    """Diagonal preselection: scores const + x.lin + x².quad [F, C] and the
    top-K ids [F, K] (int64), ties toward the lowest id (``topk_lowest``)."""
    x = x.to(f32)
    scores = dconst[None] + x @ dlin + (x * x) @ dquad
    return scores, topk_lowest(scores, top_k)


def argmax_topk(scores, top_k: int):
    """The TPU kernel's top-K (src/repro/kernels/gmm_align.py, phase 2):
    ``top_k`` masked-argmax passes over scores [F, C], each taking the first
    id attaining the row's max and setting its score to -inf -> sel [F, K]
    int64. Where no score is NaN it selects what ``diag_topk`` does, until a
    frame's scores above -inf run out: the slots after take id 0. A pass
    whose max is NaN takes C-1 (so a NaN below C-1 gives C-1 in every slot;
    a NaN at C-1 alone, C-1 first)."""
    s = scores.clone()
    F, C = s.shape
    iota = torch.arange(C, device=s.device).expand(F, C)
    cols = []
    for _ in range(top_k):
        v = s.amax(dim=1, keepdim=True)                  # NaN propagates
        idx = torch.where(s >= v, iota, C).amin(dim=1).clamp(max=C - 1)
        cols.append(idx)
        s.scatter_(1, idx[:, None], float("-inf"))
    return torch.stack(cols, 1)


def gmm_align(x, dconst, dlin, dquad, A2, top_k: int):
    """The fused alignment front half, plainly: diag preselect + top-K, then
    the packed rescore of the selected set -> (sel_ll [F, K], sel [F, K])."""
    _, sel = diag_topk(x, dconst, dlin, dquad, top_k)
    return gmm_rescore_fused(x, sel, A2), sel


def bw_stats(gamma, x):
    """Dense Baum-Welch moments: gamma [F, C] posteriors, x [F, D] ->
    (n [C], f [C, D], S [C, D*D]) with S_c = sum_f gamma_fc vec(x_f x_f^T)."""
    gamma, x = gamma.to(f32), x.to(f32)
    return gamma.sum(dim=0), gamma.T @ x, gamma.T @ _expand(x)


def tri_inverse(G, block: int = 16):
    """Inverse of a batched lower-triangular matrix by blocked matmuls
    (no triangular solve): G [..., R, R] lower-triangular -> G^{-1}.

    Recursion on [[A, 0], [B, C]]^{-1} = [[A^{-1}, 0],
    [-C^{-1} B A^{-1}, C^{-1}]] with halving splits; sub-blocks of size
    <= ``block`` factor G = D(I + N) (N strictly lower, nilpotent) and
    invert I + N by log-depth squaring: (I+N)^{-1} = (I-N)(I+N²)(I+N⁴)…
    Every step is a batched matmul.
    """
    R = G.shape[-1]
    if R <= block:
        eye = torch.eye(R, dtype=G.dtype, device=G.device)
        Dinv = 1.0 / torch.diagonal(G, dim1=-2, dim2=-1)
        N = G * Dinv[..., None] - eye
        X = eye - N
        M = -N
        p = 1
        while p < R:
            M = M @ M
            X = X + M @ X
            p *= 2
        return X * Dinv[..., None, :]
    h = (R + 1) // 2
    Ai = tri_inverse(G[..., :h, :h], block)
    Ci = tri_inverse(G[..., h:, h:], block)
    low = -(Ci @ (G[..., h:, :h] @ Ai))
    top = torch.cat([Ai, torch.zeros(G.shape[:-2] + (h, R - h),
                                     dtype=G.dtype, device=G.device)], -1)
    return torch.cat([top, torch.cat([low, Ci], -1)], -2)


def tvm_estep_l(n, U_packed):
    """Packed L-assembly: n [U, C] @ U_packed [C, P] -> [U, P] f32, with
    P = R(R+1)/2 the upper triangle of T_c^T Sigma_c^{-1} T_c (the packed
    L_u before adding I)."""
    return n.to(f32) @ U_packed.to(f32)


def tvm_estep_a(n, PP_packed):
    """Packed A-accumulation: n^T [C, U] @ PP_packed [U, P] -> [C, P] f32,
    A_c = Σ_u n_uc (Phi_u + φ_u φ_uᵀ) in packed form."""
    return n.to(f32).T @ PP_packed.to(f32)


def _packed_index_map(R: int, device=None):
    """[R, R] int64 map (r, s) -> row-major upper-triangle packed index,
    computed arithmetically: for r <= s, idx = r*R - r(r-1)/2 + (s-r),
    mirrored for the lower triangle."""
    i = torch.arange(R, device=device)
    r = torch.minimum(i[:, None], i[None, :])
    s = torch.maximum(i[:, None], i[None, :])
    return r * R - (r * (r - 1)) // 2 + (s - r)


def pack_symmetric(M):
    """[..., R, R] -> [..., R(R+1)/2] upper triangle (row-major)."""
    R = M.shape[-1]
    iu = torch.triu_indices(R, R, device=M.device)
    return M.reshape(M.shape[:-2] + (R * R,))[..., iu[0] * R + iu[1]]


def unpack_symmetric(Mp, R: int):
    """[..., R(R+1)/2] -> [..., R, R] symmetric: both triangles read the
    same packed entry, so the result is exactly symmetric."""
    idx = _packed_index_map(R, Mp.device).reshape(-1)
    return Mp[..., idx].reshape(Mp.shape[:-1] + (R, R))


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """Plain attention with the scores materialised, in f32.

    q: [B, S, H, hd]; k, v: [B, S, KVH, hd], query head h reading kv head
    h // (H // KVH). Masked scores are -1e30, as in the kernels. The
    result is in q's dtype. ``scale`` multiplies the scores: hd^-1/2
    unless given (operands staged wider than their head dim, as the bf16
    kernels take them, pass the true head dim's).
    """
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qr = q.to(f32).reshape(B, S, KVH, G, hd)
    s = torch.einsum("bqkgh,bskh->bqkgs", qr, k.to(f32)) * (
        hd ** -0.5 if scale is None else scale)
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        s = torch.where(mask[None, :, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskh->bqkgh", p, v.to(f32))
    return o.reshape(B, S, H, hd).to(q.dtype)


# scan_dtype names (``configs.base.SSMConfig.scan_dtype``) and the type of
# the scan's transitions each gives
SCAN_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}
# repro/models/mamba.py: the chunk of the reference's associative scan
SSM_CHUNK = 64


def scan_type(scan_dtype: str) -> torch.dtype:
    """The torch type of a ``scan_dtype`` name; other names raise."""
    if scan_dtype not in SCAN_DTYPES:
        raise ValueError(f"scan_dtype {scan_dtype!r}: one of "
                         f"{tuple(SCAN_DTYPES)}")
    return SCAN_DTYPES[scan_dtype]


def scan_chunk(T: int) -> int:
    """The reference's chunk (``_ssm_scan``): 64 steps, or all of T when
    64 does not divide it (T < 64 included)."""
    c = min(SSM_CHUNK, T)
    return c if c and T % c == 0 else T


def combine(al, bl, ar, br):
    """(al, bl) o (ar, br) = (al ar, bl ar + br) in the pairs' 16-bit type
    as the reference's runtime (XLA on the CPU) rounds it: in bf16 the
    product and the sum each round to bf16 (torch's ops on bf16 tensors do
    the same); in f16 the product-sum bl ar + br is formed in f32 and
    rounds once. (Read against the reference on the CPU, T = 100, ds = 64:
    rounding the f16 sum's product too leaves h_last 8.4e-4 x max|h| off,
    once 7.3e-5; rounding the bf16 product-sum once leaves it 2.6e-3 off,
    each 3.3e-8.)"""
    if al.dtype == torch.float16:
        return al * ar, (bl.to(f32) * ar.to(f32) + br.to(f32)).to(al.dtype)
    return al * ar, bl * ar + br


def tree_scan(a, b):
    """Inclusive prefixes of the pairs (a_t, b_t) along axis 1 under
    ``combine``, in the order of ``lax.associative_scan``: combine
    adjacent pairs, recurse on them, combine each odd prefix with the next
    even element, interleave. Prefix t is then the left fold, largest
    first, of the aligned power-of-two blocks that t + 1's bits give, each
    block a balanced tree of combines: the order the kernel follows."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = tree_scan(*combine(a[:, 0:n - 1:2], b[:, 0:n - 1:2],
                                a[:, 1::2], b[:, 1::2]))
    m = (n - 1) // 2                      # evens after the first
    ea, eb = combine(oa[:, :m], ob[:, :m], a[:, 2::2], b[:, 2::2])
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0], out_b[:, 0] = a[:, 0], b[:, 0]
    out_a[:, 2::2], out_b[:, 2::2] = ea, eb
    out_a[:, 1::2], out_b[:, 1::2] = oa, ob
    return out_a, out_b


def selective_scan_tree(dt, dx, A, Bc, Cc, h0=None, scan_dtype="bfloat16",
                        every: int = 0):
    """The reference's ``_ssm_scan`` at a 16-bit ``scan_dtype``, step for
    step: per chunk (``scan_chunk``) the transitions exp(dt A) and dx B
    rounded to it, their ``tree_scan`` (``combine``), then h_t = f32(aa_t) h + f32(bb_t)
    in f32 from the chunk's start state h (carried in f32 between chunks)
    and y_t = sum_s f32(bf(h_t)) f32(bf(C_t)), f32 sums. Arguments and
    result as ``selective_scan``; with ``every`` > 0 also the states
    before steps 0, every, 2 every, .. (the first h0 or zeros), as the
    kernel saves them for the backward."""
    B, T, di = dt.shape
    ds = A.shape[1]
    sd = scan_type(scan_dtype)
    dt, dx, A, Bc, Cc = (t.to(f32) for t in (dt, dx, A, Bc, Cc))
    h = (torch.zeros((B, di, ds), dtype=f32, device=dt.device)
         if h0 is None else h0.to(f32))
    y = torch.empty((B, T, di), dtype=f32, device=dt.device)
    starts = []
    c = scan_chunk(T)
    for t0 in range(0, T, c):
        ts = slice(t0, t0 + c)
        a = torch.exp(dt[:, ts, :, None] * A).to(sd)
        b = (dx[:, ts, :, None] * Bc[:, ts, None, :]).to(sd)
        aa, bb = tree_scan(a, b)
        h_all = aa.to(f32) * h[:, None] + bb.to(f32)
        if every:
            starts += [h if t == t0 else h_all[:, t - t0 - 1]
                       for t in range(t0, t0 + c) if t % every == 0]
        y[:, ts] = (h_all.to(sd).to(f32)
                    * Cc[:, ts, None, :].to(sd).to(f32)).sum(-1)
        h = h_all[:, -1]
    return (y, h, starts) if every else (y, h)


def selective_scan(dt, dx, A, Bc, Cc, h0=None, scan_dtype="float32"):
    """The Mamba recurrence, one step at a time, in f32:

        h_t = exp(dt_t A) h_{t-1} + dx_t B_t;   y_t = C_t . h_t

    dt, dx: [B, T, di]; A: [di, ds]; Bc, Cc: [B, T, ds]; h0: [B, di, ds]
    or None (zeros). Returns (y [B, T, di], h_last [B, di, ds]). A 16-bit
    ``scan_dtype`` (``SCAN_DTYPES``) runs the reference's rounded tree
    instead, ``selective_scan_tree``.
    """
    if scan_type(scan_dtype) != f32:
        return selective_scan_tree(dt, dx, A, Bc, Cc, h0, scan_dtype)
    B, T, di = dt.shape
    ds = A.shape[1]
    dt, dx, A, Bc, Cc = (t.to(f32) for t in (dt, dx, A, Bc, Cc))
    h = (torch.zeros((B, di, ds), dtype=f32, device=dt.device)
         if h0 is None else h0.to(f32))
    y = torch.empty((B, T, di), dtype=f32, device=dt.device)
    for t in range(T):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + dx[:, t, :, None] * Bc[:, t, None, :])
        y[:, t] = (h * Cc[:, t, None, :]).sum(-1)
    return y, h
