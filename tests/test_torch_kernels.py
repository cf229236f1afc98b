"""Parity of the PyTorch port's kernel entry points (``repro_torch.kernels``)
with the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side runs its Pallas kernels in interpret mode (``ops.use_pallas(True)``);
the port's CPU path is the plain version the CUDA kernels are held against
on the card. Tolerance: 2e-5 relative and absolute in f32, as in
``tests/test_kernels.py`` (the same f32 products summed in another order).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import gmm_align as jga  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bw_stats as tbw  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import gmm_align as tga  # noqa: E402
from repro_torch.kernels import gmm_loglik as tgl  # noqa: E402
from repro_torch.kernels import gmm_rescore as tgr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import tvm_estep as tte  # noqa: E402

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _precisions(rng, C, D):
    const = rng.standard_normal(C).astype(np.float32)
    lin = rng.standard_normal((D, C)).astype(np.float32)
    A = (0.3 * rng.standard_normal((C, D, D))).astype(np.float32)
    P = (np.einsum("cij,ckj->cik", A, A) + np.eye(D, dtype=np.float32))
    return const, lin, P.reshape(C, D * D).astype(np.float32)


@pytest.mark.parametrize("F,D,C,bf,bc", [
    (256, 8, 32, 128, 32),
    (300, 8, 32, 128, 32),    # ragged F
    (193, 6, 23, 64, 16),     # ragged F and C
])
def test_gmm_loglik_matches_pallas(F, D, C, bf, bc):
    rng = np.random.default_rng(F + C)
    x = rng.standard_normal((F, D)).astype(np.float32)
    const, lin, P = _precisions(rng, C, D)
    with jops.use_pallas(True):
        want = jops.gmm_loglik(jnp.asarray(x), jnp.asarray(const),
                               jnp.asarray(lin), jnp.asarray(P),
                               block_f=bf, block_c=bc)
    got = tops.gmm_loglik(_t(x), _t(const), _t(lin), _t(P))
    assert got.shape == (F, C) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("F,D,C,skew,bf,bc", [
    (256, 8, 32, 0.0, 128, 32),
    (300, 8, 32, 0.3, 128, 32),    # ragged F; P with an antisymmetric part
    (193, 6, 23, 0.0, 64, 16),     # ragged F and C
    (193, 6, 23, 0.3, 64, 16),
    (37, 72, 130, 0.1, 37, 130),   # the paper's D: E2 = 2701 pads to 2704
])
def test_gmm_loglik_packed_operand_matches_pallas(F, D, C, skew, bf, bc):
    """The CUDA kernel's operand (``packed_weights``: the symmetric part of
    P in ``align_pack``'s layout, E2-major, zero-padded to the kernel's
    tiles) times ``expand_quadratic(x)`` -- the kernel's product, written
    plainly -- is the full-width log-likelihood of any P, the Pallas
    kernel's in interpret mode included (tolerance 2e-5: the same f32
    products, the off-diagonal pairs summed once and doubled)."""
    rng = np.random.default_rng(F + C + D)
    x = rng.standard_normal((F, D)).astype(np.float32)
    const, lin, P = _precisions(rng, C, D)
    P = P.reshape(C, D, D)
    A = rng.standard_normal((C, D, D)).astype(np.float32)
    P = (P + skew * (A - A.transpose(0, 2, 1))).reshape(C, D * D)
    W = tgl.packed_weights(_t(const), _t(lin), _t(P))
    E2 = 1 + D + D * (D + 1) // 2
    assert W.dtype == torch.float32
    assert W.shape == (-(-E2 // tgl.BK) * tgl.BK, -(-C // tgl.BN) * tgl.BN)
    assert not W[E2:].any() and not W[:, C:].any()
    got = tref.expand_quadratic(_t(x)) @ W[:E2, :C]
    _close(got, tops.gmm_loglik(_t(x), _t(const), _t(lin), _t(P)))
    with jops.use_pallas(True):
        want = jops.gmm_loglik(jnp.asarray(x), jnp.asarray(const),
                               jnp.asarray(lin), jnp.asarray(P),
                               block_f=bf, block_c=bc)
    _close(got, want)
    # a symmetric P packs to align_pack's rows exactly
    Ps = P.reshape(C, D, D)
    Ps = ((Ps + Ps.transpose(0, 2, 1)) / 2).reshape(C, D * D)
    np.testing.assert_array_equal(
        tgl.packed_weights(_t(const), _t(lin), _t(Ps))[:E2, :C].numpy(),
        tref.align_pack(_t(const), _t(lin), _t(Ps)).T.numpy())


@pytest.mark.parametrize("dtype,hd,match", [
    (torch.bfloat16, 513, "head_dim 1 to 512"),
    (torch.bfloat16, 1024, "head_dim 1 to 512"),
    (torch.float32, 520, "head_dim 1 to 512"),
    (torch.bfloat16, 64, "CUDA"),       # in the domain: refused for the CPU
    (torch.bfloat16, 128, "CUDA"),
    (torch.bfloat16, 16, "CUDA"),       # every head dim from 1 to 512
    (torch.bfloat16, 80, "CUDA"),
    (torch.float32, 80, "CUDA"),
])
def test_flash_attention_refuses_bf16_head_dims_without_instance(dtype, hd,
                                                                  match):
    """A head dim past the kernels' domain (1 to 512, in both types)
    raises, naming the domain, before any device is touched: it never goes
    to a kernel or to the plain version; one inside it is refused only for
    lying on the CPU."""
    q = torch.zeros(1, 8, 2, hd, dtype=dtype)
    k = torch.zeros(1, 8, 1, hd, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, k.clone())
    assert tfa.flash_attention.launches == 0


def test_flash_attention_bf16_head_dims_are_the_cuda_instances():
    """Every bf16 head dim of the domain goes to a tensor-core instance of
    the forward entry of ``csrc/flash_attention.cu`` (``dispatch_bf16``:
    the instances of TC_WIDTHS, namespace tc up to 256 and wide's 512
    above, each head dim on the least width at or above it, ``tc_width``),
    no bf16 CUDA-core instance is dispatched, and every f32 head dim has a
    CUDA-core instance of its width ``simt_width``: the dispatch switch
    lists SIMT_WIDTHS, the width function and the ring's constants (slabs
    in flight, a slab's floats, a score slab's columns) are the
    wrapper's, and the f32 entry stages the head dims that are not a
    multiple of 4."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    body = src[src.index("int dispatch_bf16("):src.index("int prologue(")]
    widths = tuple(int(w) for w in re.findall(r"TC_CASE\((\d+)\)", body))
    assert "case wide::W:" in body and "simt" not in body
    wide = int(re.search(r"constexpr int W = (\d+);",
                         src[src.index("namespace wide {"):]).group(1))
    assert widths + (wide,) == tfa.TC_WIDTHS
    tc = src[src.index("namespace tc {"):src.index("}  // namespace tc")]
    expr = re.search(r"constexpr int width\(int hd\) \{\s+return ([^;]+);",
                     tc).group(1)
    assert " ".join(expr.split()) == (
        "hd < 1 || hd > 512 ? 0 : hd <= 64 ? 64 : hd <= 128 ? 128 : hd <= "
        "192 ? 192 : hd <= 256 ? 256 : 512")
    entry = src[src.index('extern "C" int flash_attention_bf16('):]
    assert "__nv_bfloat16>" not in src and "simt::" not in entry[
        :entry.index('extern "C" int flash_attention_geometry(')]
    f32 = src[src.index('extern "C" int flash_attention_f32('):
              src.index('extern "C" int flash_attention_bf16(')]
    assert "(hd + 3) / 4 * 4" in f32 and "restride::copy<uint32_t>(3," in f32
    simt = src[src.index("namespace simt {"):src.index("}  // namespace simt")]
    listed = simt[simt.index("#define SIMT_WIDTH_LIST(X)"):
                  simt.index("inline int dispatch(")]
    assert tuple(int(w) for w in re.findall(r"X\((\d+)\)", listed)) == \
        tfa.SIMT_WIDTHS
    body = simt[simt.index("inline int dispatch("):]
    assert "SIMT_WIDTH_LIST(SIMT_CASE)" in body
    expr = re.search(r"constexpr int width\(int hd\) \{\s+return ([^;]+);",
                     simt).group(1)
    assert " ".join(expr.split()) == (
        "hd < 1 || hd > 512 ? 0 : hd <= 256 ? (hd + 31) / 32 * 32 : (hd + "
        "63) / 64 * 64")
    consts = {n: int(re.search(rf"constexpr int {n} = (\d+);", simt).group(1))
              for n in ("STAGES", "DC", "SLICES")}
    assert consts == {"STAGES": tfa.SIMT_STAGES, "DC": tfa.SIMT_DC,
                      "SLICES": 1}
    assert "constexpr int STAGE = TILE * SLD;" in simt
    assert tfa.HEAD_DIMS == tuple(range(1, 513))
    for hd in tfa.HEAD_DIMS:
        assert tfa.route(torch.bfloat16, hd) == "tc"
        w = tfa.tc_width(hd)
        assert w in tfa.TC_WIDTHS and hd <= w and all(
            v < hd for v in tfa.TC_WIDTHS if v < w)
        assert tfa.ld(hd) % 8 == 0 and hd <= tfa.ld(hd) < hd + 8
        assert tfa.route(torch.float32, hd) == "simt"
        n = tfa.ld(hd, torch.float32)
        assert n % 4 == 0 and hd <= n < hd + 4
        assert tfa.staged(torch.float32, hd) == (n != hd)
        w = tfa.simt_width(hd)
        assert w in tfa.SIMT_WIDTHS and hd <= w and all(
            v < hd for v in tfa.SIMT_WIDTHS if v < w)


@pytest.mark.parametrize("F,D,C,K,case", [
    pytest.param(64, 8, 32, 5, "", id="64-8-32-5"),
    pytest.param(37, 6, 16, 16, "", id="37-6-16-16"),  # ragged F, K == C
    pytest.param(50, 8, 32, 1, "", id="K1"),
    pytest.param(64, 8, 32, 5, "bucket", id="padded-bucket"),
    pytest.param(40, 7, 12, 4, "asym", id="P-not-symmetric"),
])
def test_gmm_rescore_matches_pallas(F, D, C, K, case):
    """Duplicate, boundary and out-of-range ids: both wrappers clip into
    [0, C) and score each slot independently. Also K = 1; a serving
    bucket whose padded frames (most of them here) all carry the same K
    ids; and a P that is not symmetric, which both use whole."""
    rng = np.random.default_rng(F * K)
    x = rng.standard_normal((F, D)).astype(np.float32)
    const, lin, P = _precisions(rng, C, D)
    if case == "asym":
        P = P + 0.3 * rng.standard_normal(P.shape).astype(np.float32)
    sel = rng.integers(0, C, size=(F, K)).astype(np.int32)
    if case == "bucket":
        sel[F // 4:] = sel[F // 4]
    sel[0, :] = sel[0, 0]                 # duplicates
    sel[1, 0], sel[1, -1] = 0, C - 1      # boundaries
    sel[2, 0], sel[2, -1] = -3, C + 5     # out of range: clipped
    with jops.use_pallas(True):
        want = jops.gmm_rescore(jnp.asarray(x), jnp.asarray(sel),
                                jnp.asarray(const), jnp.asarray(lin),
                                jnp.asarray(P), block_f=8)
    got = tops.gmm_rescore(_t(x), _t(sel), _t(const), _t(lin), _t(P))
    assert got.shape == (F, K)
    _close(got, want)
    # the cached pack gives the same answer as the unpacked operands
    pack = tref.rescore_pack(_t(const), _t(lin), _t(P))
    _close(pack, jref.rescore_pack(jnp.asarray(const), jnp.asarray(lin),
                                   jnp.asarray(P)))
    # the CUDA kernel's grouping, in plain tensor code: pairs sorted by
    # component, cut by work_items, scored an item at a time
    ids = _t(sel).long().clamp(0, C - 1)
    for bp in (tgr.BP, 3):
        _close(_grouped(_t(x), ids, pack, bp), want)


def _grouped(x, sel, A, bp):
    F, D = x.shape
    K = sel.shape[1]
    flat = sel.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    out = torch.full((F * K,), float("nan"))
    counts = torch.bincount(flat, minlength=A.shape[0])
    for c, first, n in tgr.work_items(counts, bp).tolist():
        p = order[first:first + n]
        assert 1 <= n <= bp and (flat[p] == c).all()
        xs = x[p // K]
        P = A[c, 1 + D:1 + D + D * D].reshape(D, D)
        out[p] = (A[c, 0] + xs @ A[c, 1:1 + D]) - 0.5 * ((xs @ P) * xs).sum(1)
    return out.reshape(F, K)


@pytest.mark.parametrize("seed", range(4))
def test_gmm_rescore_geometry(seed):
    """Work items cover every pair exactly once, each within its
    component's segment, for any histogram (empty components, one hot
    component, counts on and off multiples of BP); their number stays
    within the ceil(F*K / BP) + C that the wrapper allocates; a block's
    shared memory fits; F*K >= 2**31, a D too wide and a C whose histogram
    does not fit are refused."""
    rng = np.random.default_rng(seed)
    C = int(rng.integers(1, 300))
    counts = rng.integers(0, 200, size=C) * (rng.uniform(size=C) < 0.7)
    counts[rng.integers(0, C)] += int(rng.integers(0, 5000))
    counts[rng.integers(0, C)] = tgr.BP * int(rng.integers(1, 4))
    pairs = int(counts.sum())
    K = int(rng.integers(1, 41))
    F = -(-pairs // K)
    counts[0] += F * K - pairs            # exactly F*K pairs
    g = tgr.geometry(F, K, C, 72)
    assert g.bp == tgr.BP and g.max_items == -(-F * K // tgr.BP) + C
    assert g.scratch_words == (-(-(2 * C + 1) // 4) * 4 + 4 * g.max_items
                               + F * K)
    seg = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]))
    for bp in (tgr.BP, int(rng.integers(1, 100))):
        items = tgr.work_items(torch.from_numpy(counts), bp)
        assert items.shape[0] <= -(-F * K // bp) + C
        c, first, n = items.T
        assert ((n >= 1) & (n <= bp)).all()
        # in order, item after item, they tile [0, F*K) without a gap
        assert first[0] == 0 and (first[1:] == (first + n)[:-1]).all()
        assert int((first + n)[-1]) == F * K
        assert ((first >= seg[c]) & (first + n <= seg[c + 1])).all()
    for D in (1, 7, 8, 72, 144, 200):
        g = tgr.geometry(100, 20, 2048, D)
        assert g.smem_bytes <= 232448 and g.strip == tgr.p_rows(D)
    # past D = 200 P comes in strips of STRIP rows
    g = tgr.geometry(100, 20, 2048, 201)
    assert g.strip == tgr.STRIP and g.smem_bytes <= 232448
    assert tgr.smem_bytes(201, tgr.p_rows(201)) > 232448
    # past C = 58,112 the sort's counts go to device memory
    assert tgr.geometry(100, 20, 232448 // 4 + 1, 72).hist_global == 1
    assert tgr.geometry(100, 20, 232448 // 4, 72).hist_global == 0
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tgr.geometry(2 ** 31 // 20 + 1, 20, 2048, 72)
    tgr.geometry(2 ** 31 // 20, 20, 2048, 72)


def test_gmm_rescore_constants_are_the_cuda_ones():
    """The wrapper's geometry constants are csrc/gmm_rescore.cu's."""
    src = (_build.CSRC / "gmm_rescore.cu").read_text()
    for name, value in (("BP", tgr.BP), ("COLS", tgr.COLS),
                        ("STRIP", tgr.STRIP), ("MAX_SMEM", tgr.MAX_SMEM)):
        assert re.search(rf"constexpr [a-z ]+ {name} = {value};", src), name


@pytest.mark.parametrize("F,D,C,bf,bc", [
    (256, 5, 8, 128, 8),
    (300, 6, 23, 100, 23),    # F and C off the CUDA kernel's 128-tiles
])
def test_bw_stats_matches_pallas(F, D, C, bf, bc):
    rng = np.random.default_rng(F + C)
    x = rng.standard_normal((F, D)).astype(np.float32)
    gamma = rng.dirichlet(np.ones(C), size=F).astype(np.float32)
    gamma[rng.uniform(size=(F, C)) < 0.5] = 0.0      # sparse, as after top-K
    with jops.use_pallas(True):
        want = jops.bw_stats(jnp.asarray(gamma), jnp.asarray(x),
                             block_f=bf, block_c=bc)
    got = tops.bw_stats(_t(gamma), _t(x))
    assert [tuple(g.shape) for g in got] == [(C,), (C, D), (C, D * D)]
    for g, w in zip(got, want):
        _close(g, w)


def _diag_coeffs(rng, C, D, ties=()):
    """Diag preselection coefficients; each (dst, src) in ``ties`` copies a
    component, so its scores tie exactly with the source's."""
    dconst = rng.standard_normal(C).astype(np.float32)
    dlin = rng.standard_normal((D, C)).astype(np.float32)
    dquad = -rng.uniform(0.2, 1.0, (D, C)).astype(np.float32)
    for dst, src in ties:
        dconst[dst], dlin[:, dst], dquad[:, dst] = (
            dconst[src], dlin[:, src], dquad[:, src])
    return dconst, dlin, dquad


@pytest.mark.parametrize("F,D,C,K,bf,ties", [
    (32, 5, 8, 4, 8, ()),
    (37, 6, 23, 5, 37, ((4, 2), (9, 2), (7, 20))),  # ragged F, C; ties
])
def test_gmm_align_matches_pallas(F, D, C, K, bf, ties):
    """Same selected ids (ties toward the lowest id) and scores as the
    Pallas kernel, whose quadratic expansion is ``align_expand_operand``."""
    rng = np.random.default_rng(F * K)
    x = rng.standard_normal((F, D)).astype(np.float32)
    dconst, dlin, dquad = _diag_coeffs(rng, C, D, ties)
    const, lin, P = _precisions(rng, C, D)
    A2 = tref.align_pack(_t(const), _t(lin), _t(P))
    E2 = A2.shape[1]
    want_ll, want_sel = jga.gmm_align(
        jnp.asarray(x), jnp.asarray(dconst)[None], jnp.asarray(dlin),
        jnp.asarray(dquad), jops.align_expand_operand(D, E2),
        jnp.asarray(A2.numpy()), top_k=K, block_f=bf, dma_depth=2)
    got_ll, got_sel = tops.gmm_align(_t(x), _t(dconst), _t(dlin),
                                     _t(dquad), A2, top_k=K)
    assert got_sel.dtype == torch.int64 and got_ll.shape == (F, K)
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
    _close(got_ll, want_ll)
    if ties:
        # copies 4 and 9 of component 2 follow it, in id order
        rows = [list(r) for r in got_sel.numpy() if 2 in r[:K - 2]]
        assert rows
        for r in rows:
            assert r.index(2) + 1 == r.index(4) and r.index(4) + 1 == r.index(9)


def _pallas_sel(x, dconst, dlin, dquad, K, bf):
    """The Pallas kernel's selection (interpret mode), any packed rows."""
    F, D = x.shape
    C = dconst.shape[0]
    A2 = tref.align_pack(torch.zeros(C), torch.zeros(D, C),
                         torch.eye(D).reshape(1, D * D).repeat(C, 1))
    _, sel = jga.gmm_align(
        jnp.asarray(x), jnp.asarray(dconst)[None], jnp.asarray(dlin),
        jnp.asarray(dquad), jops.align_expand_operand(D, A2.shape[1]),
        jnp.asarray(A2.numpy()), top_k=K, block_f=bf, dma_depth=2)
    return np.asarray(sel)


@pytest.mark.parametrize("C,K,chunk,ties", [
    (300, 7, 128, ((128, 127), (256, 255), (129, 3))),  # C ragged to 128
    (300, 7, 16, ((16, 15), (32, 31), (47, 3))),
    (300, 6, 7, ((7, 6), (14, 13), (22, 0))),            # a ragged width
    (23, 23, 128, ((4, 2), (9, 2))),                     # K = C
    (23, 23, 8, ((8, 7), (16, 7))),
])
def test_streaming_topk_matches_pallas_and_plain(C, K, chunk, ties):
    """The kernel's top-K (``streaming_topk``: chunks merged into a running
    best-K list) selects what the Pallas kernel's K masked-argmax passes
    and the plain stable sort select, in the same order. Each (dst, src)
    copies a boosted component, so its scores tie exactly with the
    source's across a chunk boundary; the lower id goes first."""
    F, D = 16, 5
    rng = np.random.default_rng(C + K + chunk)
    x = rng.standard_normal((F, D)).astype(np.float32)
    dconst, dlin, dquad = _diag_coeffs(rng, C, D)
    for _, src in ties:
        dconst[src] += 40.0          # in every frame's top K
    for dst, src in ties:
        dconst[dst], dlin[:, dst], dquad[:, dst] = (
            dconst[src], dlin[:, src], dquad[:, src])
    scores, want = tref.diag_topk(_t(x), _t(dconst), _t(dlin), _t(dquad), K)
    got = tga.streaming_topk(scores, K, chunk)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(tref.argmax_topk(scores, K).numpy(),
                                  want.numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  _pallas_sel(x, dconst, dlin, dquad, K, 8))
    for dst, src in ties:
        lo, hi = min(dst, src), max(dst, src)
        for r in got.numpy().tolist():
            assert r.index(lo) < r.index(hi)


@pytest.mark.parametrize("nan_frame,nan_last,ninf", [
    (True, False, False), (False, True, False), (True, True, False),
    (False, False, True), (False, True, True), (True, False, True)])
def test_streaming_topk_nan_rule_matches_pallas(nan_frame, nan_last, ninf):
    """A frame whose scores hold a NaN below C-1 selects C-1 in every
    slot; a NaN at C-1 alone puts C-1 first, then the best K-1 of the
    others; with zero-weight components (a dconst of -inf) leaving fewer
    than K scores above -inf, the slots after them take id 0: what the
    Pallas kernel's masked-argmax passes give, and so both instances of
    the CUDA kernel (the streaming merge, ``streaming_topk``; the argmax
    passes over whole rows, as ``ref.argmax_topk``)."""
    F, D, C, K = 16, 5, 300, 6
    rng = np.random.default_rng(11)
    x = rng.standard_normal((F, D)).astype(np.float32)
    dconst, dlin, dquad = _diag_coeffs(rng, C, D)
    finite = np.array([7, 130, 131, 256])       # across chunk boundaries
    if ninf:
        keep = np.zeros(C, bool)
        keep[finite] = True
        dconst[~keep] = -np.inf
    if nan_frame:
        x[2] = np.nan
    if nan_last:
        dconst[C - 1] = np.nan
    scores, _ = tref.diag_topk(_t(x), _t(dconst), _t(dlin), _t(dquad), K)
    want = _pallas_sel(x, dconst, dlin, dquad, K, 8)
    got = tga.streaming_topk(scores, K).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tref.argmax_topk(scores, K).numpy(), want)
    if nan_frame:
        assert (got[2] == C - 1).all()
    if nan_last:
        assert (got[:, 0] == C - 1).all()
    if ninf:
        ok = [f for f in range(F) if not (nan_frame and f == 2)]
        first = 1 if nan_last else 0
        assert (np.sort(got[ok, first:first + 4], axis=1) == finite).all()
        assert (got[ok, first + 4:] == 0).all()


def test_gmm_align_geometry_fits_shared_memory():
    """Blocks of the kernel: at the paper's width (C=2048, D=72, K=20) the
    streaming instance, 64 frames in 109,056 bytes, two blocks in an SM's
    228 KB; the rescore alone runs with the same blocks; K above 32 takes the
    whole-row instance, 16 frames, then 8 once 16 rows outgrow a block
    (C = 4096, K = 40, which the previous 8-frame kernel took too), until
    8 rows outgrow it above C = 6272, where the spill form takes over (its
    preselect's 64-frame blocks)."""
    narrow = (False, False)                    # (spill, wide)
    assert tga.geometry(2048, 72, 20) == (64, True, 109056, *narrow)
    assert 2 * (109056 + 1024) <= 228 * 1024 < 3 * (109056 + 1024)
    assert tga.geometry(2048, 72, 40, rescore_only=True) == (
        64, True, 109056, *narrow)
    assert tga.geometry(2048, 72, 40) == (16, False, 160256, *narrow)
    assert tga.geometry(2048, 72, 2048)[:2] == (16, False)
    assert tga.geometry(3072, 72, 40)[:2] == (16, False)
    assert tga.geometry(3073, 72, 40)[:2] == (8, False)
    assert tga.geometry(4096, 72, 40) == (8, False, 160256, *narrow)
    assert tga.geometry(4096, 72, 4096)[:2] == (8, False)
    assert tga.geometry(6272, 72, 40)[2] <= tga.MAX_SMEM
    assert tga.geometry(6272, 72, 40)[3:] == narrow
    g = tga.geometry(6273, 72, 40)
    assert g.spill and not g.wide and (g.rows, g.stream) == (64, False)
    assert tga.smem_bytes(6273, 72, False, 8) > tga.MAX_SMEM
    for C, D, K in ((23, 6, 5), (2048, 72, 32), (300, 5, 7)):
        bf, stream, smem, _, _ = tga.geometry(C, D, K)
        assert stream and bf == tga.BF_STREAM and smem <= tga.MAX_SMEM


def test_gmm_align_geometry_constants_are_the_cuda_ones():
    """``geometry``'s constants are those of csrc/gmm_align.cu, and its
    frame counts those of the kernel's two instances (16 FM frame slots);
    the shared memory for a shape is checked against the CUDA side's own
    answer on the card (chip_smoke.py, ``kernel_geometry``)."""
    src = (_build.CSRC / "gmm_align.cu").read_text()
    const = {k: int(v) for k, v in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    for name in ("NC", "BKD", "STAGES", "STREAM_K", "MAX_SMEM"):
        assert const[name] == getattr(tga, name), name
    inst = dict((s, 16 * int(fm)) for fm, s in
                re.findall(r"launch_instance<(\d+), (true|false)>\(", src))
    assert inst == {"true": tga.BF_STREAM, "false": tga.BF_PRODUCT_ROWS}
    assert re.search(r"g\.rows = g\.stream \? (\d+) : (\d+); g\.rows >= "
                     r"(\d+); g\.rows /= 2", src).groups() == tuple(
                         str(n) for n in (tga.BF_STREAM, *tga.BF_ROWS))


def test_align_pack_expand_and_fused_rescore_match_jax():
    """The packed-symmetric rows, the frame expansion and the fused rescore
    (both JAX strategies compute the same function) agree with JAX, and
    the fused rescore agrees with the full-row sparse rescore."""
    rng = np.random.default_rng(5)
    F, D, C, K = 24, 5, 8, 4
    x = rng.standard_normal((F, D)).astype(np.float32)
    const, lin, P = _precisions(rng, C, D)
    sel = rng.integers(0, C, size=(F, K))
    A2 = tref.align_pack(_t(const), _t(lin), _t(P))
    jA2 = jref.align_pack(jnp.asarray(const), jnp.asarray(lin),
                          jnp.asarray(P))
    _close(A2, jA2)
    _close(tref.expand_quadratic(_t(x)), jref.expand_quadratic(jnp.asarray(x)))
    got = tops.gmm_rescore_fused(_t(x), _t(sel), A2)
    for strategy in ("full", "union"):
        _close(got, jref.gmm_rescore_fused(
            jnp.asarray(x), jnp.asarray(sel.astype(np.int32)), jA2,
            strategy=strategy, block_f=8), 1e-4)
    _close(got, tops.gmm_rescore(_t(x), _t(sel), _t(const), _t(lin),
                                 _t(P)), 1e-4)


def _estep_operands(rng, U, C, R):
    P = R * (R + 1) // 2
    n = rng.uniform(0.0, 5.0, size=(U, C)).astype(np.float32)
    Up = rng.standard_normal((C, P)).astype(np.float32)
    PPp = rng.standard_normal((U, P)).astype(np.float32)
    return n, Up, PPp


@pytest.mark.parametrize("U,C,R,blocks", [
    (16, 24, 10, dict(block_u=8, block_p=32, block_c=8)),
    (13, 21, 5, dict(block_u=8, block_p=8, block_c=8)),   # ragged U/C, odd P
])
def test_tvm_estep_matches_pallas(U, C, R, blocks):
    rng = np.random.default_rng(U * C + R)
    n, Up, PPp = _estep_operands(rng, U, C, R)
    with jops.use_pallas(True):
        want_l = jops.tvm_estep_l(jnp.asarray(n), jnp.asarray(Up), **blocks)
        want_a = jops.tvm_estep_a(jnp.asarray(n), jnp.asarray(PPp),
                                  **blocks)
    got_l = tops.tvm_estep_l(_t(n), _t(Up))
    got_a = tops.tvm_estep_a(_t(n), _t(PPp))
    assert got_l.shape == (U, R * (R + 1) // 2)
    assert got_a.shape == (C, R * (R + 1) // 2)
    _close(got_l, want_l)
    _close(got_a, want_a)


def test_tvm_estep_bf16_matches_jnp_path():
    """bf16 casts the inputs only; both sides widen them exactly and
    accumulate in f32, so they differ by f32 summation order alone
    (tolerance 2e-5, as for f32). The reference is the jnp path: the
    Pallas bf16 interpret path is a known-failing reference test."""
    rng = np.random.default_rng(7)
    n, Up, PPp = _estep_operands(rng, 40, 24, 10)
    with jops.use_pallas(False):
        want_l = jops.tvm_estep_l(jnp.asarray(n), jnp.asarray(Up),
                                  dtype="bfloat16")
        want_a = jops.tvm_estep_a(jnp.asarray(n), jnp.asarray(PPp),
                                  dtype="bfloat16")
    got_l = tops.tvm_estep_l(_t(n), _t(Up), dtype="bfloat16")
    got_a = tops.tvm_estep_a(_t(n), _t(PPp), dtype="bfloat16")
    assert got_l.dtype == torch.float32 and got_a.dtype == torch.float32
    _close(got_l, want_l)
    _close(got_a, want_a)
    # the knob changes the compute dtype, by a bf16-sized amount
    f32_l = tops.tvm_estep_l(_t(n), _t(Up))
    rel = float((got_l - f32_l).abs().max() / f32_l.abs().max())
    assert 0.0 < rel < 3e-2
    with pytest.raises(ValueError):
        tops.tvm_estep_l(_t(n), _t(Up), dtype="float16")


@pytest.mark.parametrize("dtype,M,want", [
    (torch.float32, 1, "stream"),
    (torch.float32, 16, "stream"),      # the serving L: U = max_batch
    (torch.float32, 17, "sgemm"),
    (torch.float32, 512, "sgemm"),      # L at training, A (M = C)
    (torch.bfloat16, 16, "stream"),
    (torch.bfloat16, 17, "wgmma"),
    (torch.bfloat16, 2048, "wgmma"),
])
def test_packed_matmul_form_is_a_function_of_dtype_and_m(dtype, M, want):
    """The kernel of csrc/packed_matmul.cu that runs: the stream form up to
    M = 16 on either side of the threshold, then the CUDA-core SGEMM (f32)
    or wgmma (bf16); K and N choose nothing."""
    for K, N in ((1, 1), (2048, 80200), (13, 77)):
        assert tte.form(dtype, M, K, N) == want
    assert set(tte.FORMS) == {"stream", "sgemm", "wgmma"}


@pytest.mark.parametrize("U,C,R", [
    (24, 21, 6),     # C and P = 21 both off a multiple of 8
    (40, 16, 5),     # P = 15 only
    (33, 13, 15),    # C only (P = 120)
])
def test_tma_pad_gives_the_unpadded_product(U, C, R):
    """The wgmma form's TMA pad: n and b padded to rows of a multiple of 8
    elements (zeros past C or P), read through the padded row length, give
    the unpadded product, checked through the plain version of the kernels'
    function against the Pallas kernel in interpret mode, for L and A."""
    rng = np.random.default_rng(U + C + R)
    n, Up, PPp = _estep_operands(rng, U, C, R)
    P = Up.shape[1]
    with jops.use_pallas(True):
        want_l = jops.tvm_estep_l(jnp.asarray(n), jnp.asarray(Up))
        want_a = jops.tvm_estep_a(jnp.asarray(n), jnp.asarray(PPp))
    n_p, up_p, pp_p = (tte.tma_pad(_t(a)) for a in (n, Up, PPp))
    for t, cols in ((n_p, C), (up_p, P), (pp_p, P)):
        assert t.shape[1] % 8 == 0 and t.shape[1] - cols < 8
        assert not t[:, cols:].any()
    ld = n_p.shape[1]
    got_l = tte.plain(n_p, up_p, U, C, ld, 1)[:, :P]
    got_a = tte.plain(n_p, pp_p, C, U, 1, ld)[:, :P]
    _close(got_l, want_l)
    _close(got_a, want_a)
    aligned = _t(np.zeros((3, 16), np.float32))
    assert tte.tma_pad(aligned) is aligned


@pytest.mark.parametrize("stride_m,stride_k", [
    (21, 2), (2, 21), (1, 1), (20, 1), (1, 20), (22, 1)])
def test_packed_matmul_refuses_other_strides(stride_m, stride_k):
    """a [rows, ld] is read only as (ld, 1) or (1, ld): any other stride
    pair raises before anything reaches the card."""
    a = torch.zeros(5, 21)
    b = torch.zeros(21, 8)
    with pytest.raises(ValueError, match="strides"):
        tte.packed_matmul(a, b, 5, 21, stride_m, stride_k)
    with pytest.raises(ValueError, match="strides"):
        tte.plain(a, b, 5, 21, stride_m, stride_k)
    # the two allowed pairs, past the stride check, need a CUDA tensor
    with pytest.raises(ValueError, match="CUDA"):
        tte.packed_matmul(a, b, 5, 21, 21, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tte.packed_matmul(a, b[:5], 21, 5, 1, 21)


@pytest.mark.parametrize("D", [1, 5, 72, 254, 255, 512])
def test_bw_stats_pair_table_matches_quad_pairs(D):
    """The kernel's column codes (i0 | i1 << 16 over [x | 1 | 0]): the
    upper-triangle pairs in the order of the port's and the JAX package's
    ``_quad_pairs``, then x_d, then the ones column, then zeros to a
    multiple of the kernel's 128-column tile."""
    table = tbw.pair_table(D).numpy()
    E = tbw.n_columns(D)
    P = D * (D + 1) // 2
    assert table.dtype == np.int32 and table.shape[0] % tbw.BN == 0
    assert 0 <= table.shape[0] - E < tbw.BN
    i0, i1 = table & 0xFFFF, table >> 16
    t0, t1, _ = tref._quad_pairs(D)
    j0, j1, _ = jref._quad_pairs(D)
    np.testing.assert_array_equal(i0[:P], t0.numpy())
    np.testing.assert_array_equal(i1[:P], t1.numpy())
    np.testing.assert_array_equal(i0[:P], np.asarray(j0))
    np.testing.assert_array_equal(i1[:P], np.asarray(j1))
    np.testing.assert_array_equal(i0[P:P + D], np.arange(D))
    assert (i1[P:P + D] == D).all() and i0[P + D] == i1[P + D] == D
    assert (i0[E:] == D + 1).all() and (i1[E:] == D + 1).all()


def _gamma(rng, F, C, kind):
    """Posteriors of one of four kinds: "sparse" (half the entries zero, as
    after top-K), "dense", "zero", or "hole" (sparse, with components
    128..255 never touched: a 128-component tile with no frames)."""
    gamma = rng.dirichlet(np.ones(C), size=F).astype(np.float32)
    if kind in ("sparse", "hole"):
        gamma[rng.uniform(size=(F, C)) < 0.5] = 0.0
    if kind == "hole":
        gamma[:, 128:256] = 0.0
    if kind == "zero":
        gamma[:] = 0.0
    return gamma


@pytest.mark.parametrize("F,D,C,kind", [
    (256, 5, 300, "dense"),
    (300, 6, 300, "zero"),
    (301, 4, 300, "hole"),      # ragged F; tile 1 has no frames
    (77, 3, 129, "sparse"),     # ragged F and C (a 1-component tile)
])
@pytest.mark.parametrize("tile", [128, 64])
def test_bw_stats_frame_lists_match_numpy(F, D, C, kind, tile):
    """The compaction's plain version: each component tile's frames (128
    wide in the rows form, 64 in the pairs form) with a non-zero Γ, in
    frame order, against numpy."""
    rng = np.random.default_rng(F + C)
    gamma = _gamma(rng, F, C, kind)
    lists = tbw.frame_lists(_t(gamma), tile)
    assert len(lists) == -(-C // tile)
    for t, got in enumerate(lists):
        want = np.flatnonzero((gamma[:, tile * t:tile * (t + 1)] != 0)
                              .any(axis=1))
        np.testing.assert_array_equal(got.numpy(), want)
    if kind == "dense":
        assert all(len(li) == F for li in lists)
    if kind == "zero":
        assert all(len(li) == 0 for li in lists)
    if kind == "hole":
        hole = 1 if tile == 128 else 2
        assert len(lists[hole]) == 0 and len(lists[0]) > 0


@pytest.mark.parametrize("F,D,C,kind,nsplit", [
    (256, 5, 8, "sparse", 1),
    (300, 6, 300, "hole", 3),     # ragged F and C; a tile with no frames
    (301, 4, 300, "dense", 4),
    (40, 3, 9, "zero", 2),
    (40, 3, 9, "sparse", 4),      # runs with no frames
])
@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("form", ["rows", "pairs"])
def test_bw_stats_table_moments_match_pallas(F, D, C, kind, nsplit, compact,
                                             form):
    """The kernel's arithmetic in plain tensor code: for each component
    tile, its frames (all, or its compacted list) in ``nsplit`` runs; Γᵀ X₂
    over the coded columns per run, added in run order, scattered by code;
    in either form's table and tiles (rows: ``pair_table``, 128
    components; pairs: ``pairs_table``, 64); against the Pallas kernel in
    interpret mode and the port's plain version. S comes out exactly
    symmetric."""
    rng = np.random.default_rng(F + D + C)
    x = rng.standard_normal((F, D)).astype(np.float32)
    gamma = _gamma(rng, F, C, kind)
    with jops.use_pallas(True):
        want = jops.bw_stats(jnp.asarray(gamma), jnp.asarray(x),
                             block_f=F, block_c=C)
    if form == "rows":
        got = tbw.moments(_t(gamma), _t(x), tbw.pair_table(D), nsplit,
                          compact)
    else:
        got = tbw.moments(_t(gamma), _t(x), tbw.pairs_table(D), nsplit,
                          compact, tbw.PM)
    plain = tref.bw_stats(_t(gamma), _t(x))
    for g, w, p in zip(got, want, plain):
        _close(g, w)
        _close(g, p)
    S = got[2].reshape(C, D, D)
    assert torch.equal(S, S.transpose(1, 2))


def test_bw_stats_splits_fill_the_waves():
    """Frame runs: at the paper's width (352 tiles against 264 slots of
    132 SMs) three runs fill whole waves; a run is a multiple of the
    16-frame slab and the runs cover the frames; short F takes one run."""
    assert tbw.splits(32768, 2048, 72, 132) == 3
    assert tbw.splits(262144, 2048, 72, 132) == 3
    assert tbw.splits(1000, 2048, 72, 132) == 1
    assert tbw.split_len(32768, 3) == 10928
    for F in (0, 1, 1000, 5000, 32768, 262144):
        n = tbw.splits(F, 2048, 72, 132)
        per = tbw.split_len(F, n)
        assert 1 <= n <= tbw.MAX_SPLITS and per % tbw.BK == 0
        assert n * per >= F and (n - 1) * per < max(F, 1)


@pytest.mark.parametrize("R,block", [(7, 16), (40, 8)])
def test_tri_inverse_matches_jax(R, block):
    rng = np.random.default_rng(R)
    A = rng.standard_normal((3, R, R)).astype(np.float32)
    G = np.tril(A) * 0.1 + np.eye(R, dtype=np.float32) * 2.0
    want = jref.tri_inverse(jnp.asarray(G), block)
    got = tref.tri_inverse(_t(G), block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("R", [1, 6])
def test_pack_unpack_symmetric_match_jax(R):
    rng = np.random.default_rng(R)
    A = rng.standard_normal((2, R, R)).astype(np.float32)
    M = A + A.transpose(0, 2, 1)
    p = tref.pack_symmetric(_t(M))
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jref.pack_symmetric(jnp.asarray(M))))
    np.testing.assert_array_equal(tref.unpack_symmetric(p, R).numpy(), M)
    np.testing.assert_array_equal(
        tref._packed_index_map(R).numpy(),
        np.asarray(jref._packed_index_map(R)))


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor never reaches a
    silent fallback inside them (the plain version is chosen in ops)."""
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tgl.gmm_loglik(x, torch.zeros(2), torch.zeros(3, 2),
                       torch.zeros(2, 9))
    with pytest.raises(ValueError, match="CUDA"):
        tgr.gmm_rescore(x, torch.zeros(4, 2, dtype=torch.int64),
                        torch.zeros(2, 13))
    with pytest.raises(ValueError, match="CUDA"):
        tte.tvm_estep_l(torch.zeros(2, 3), torch.zeros(3, 6))
    with pytest.raises(ValueError, match="CUDA"):
        tbw.bw_stats(torch.zeros(4, 2), x)
    A2 = torch.zeros(2, 1 + 3 + 6)
    with pytest.raises(ValueError, match="CUDA"):
        tga.gmm_align(x, torch.zeros(2), torch.zeros(3, 2),
                      torch.zeros(3, 2), A2, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tga.gmm_rescore_fused(x, torch.zeros(4, 1, dtype=torch.int64), A2)
    assert (tgl.gmm_loglik.launches, tgr.gmm_rescore.launches,
            tte.tvm_estep_l.launches, tbw.bw_stats.launches,
            tga.gmm_align.launches,
            tga.gmm_rescore_fused.launches) == (0, 0, 0, 0, 0, 0)


def test_build_names_every_source(tmp_path, monkeypatch):
    """Every CUDA source under csrc/ has its entry signatures, and its
    library name follows the hash of the source and of the csrc/ headers it
    includes into the ignored build dir: an edited header renames the
    library of every source that includes it, and of no other."""
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    for name in sources:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    for name in ("packed_matmul", "bw_stats", "gmm_loglik", "gmm_align",
                 "gmm_rescore"):
        assert _build.includes(name) == ["hopper.cuh"]
    for name in ("flash_attention", "flash_attention_bwd"):
        assert _build.includes(name) == ["flash_attention_simt.cuh",
                                         "hopper.cuh", "restride.cuh"]
    for name in ("selective_scan", "selective_scan_bwd"):
        assert _build.includes(name) == ["hopper.cuh", "selective_scan.cuh"]
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    for header in ("hopper.cuh", "restride.cuh",
                   "flash_attention_simt.cuh"):
        before = {n: _build.library_path(n) for n in sources}
        with open(tmp_path / header, "a") as fh:
            fh.write("// edited\n")
        after = {n: _build.library_path(n) for n in sources}
        for n in sources:
            assert (before[n] != after[n]) == (header in _build.includes(n))
