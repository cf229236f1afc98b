"""The i-vector kernels across the reference's whole shape range, on the CPU.

Every (C, D, K) with D <= 512, C <= 65,536 and 1 <= K <= C has a form in
each of ``gmm_align``, ``gmm_rescore``, ``gmm_loglik`` and ``bw_stats``
(the one refusal left is ``gmm_rescore``'s F*K >= 2**31), every form's
block fits in shared memory, the wrappers' constants are the ``.cu``
files', and the paper's shapes keep the forms they had. The new forms'
arithmetic is held in plain tensor code: the spill form's top-K select
(its keys, radix passes and tie rule) against ``ref.argmax_topk``, the
plain top-K and ``lax.top_k``; the wide pair codes against
``ref.expand_quadratic``; the rescore's strip sums and the moments with
16-bit codes against the plain versions and the JAX package; gmm_loglik's
rows form (the sum by rows of the triangle, 3xTF32) and bw_stats' pairs
form (S's triangle in (I, J) tiles of 64 components) in their own order
against both. Then the i-vector path at D = 256 (C = 16) and at K = C
against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the port
runs on the CPU (its plain versions). Tolerances: selections exact; the
codes' expansions bitwise (the same two f32 products); sums 2e-5 relative
to the largest |value| (f32 summed in another order over up to D^2 =
65,536 terms); 1e-4 relative where a Cholesky factor or a solve of a
256 x 256 system sits between input and output.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import alignment as JAL  # noqa: E402
from repro.core import engine as JEN  # noqa: E402
from repro.core import tvm as JTV  # noqa: E402
from repro.core import ubm as JU  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import alignment as TAL  # noqa: E402
from repro_torch.core import engine as TEN  # noqa: E402
from repro_torch.core import tvm as TTV  # noqa: E402
from repro_torch.core import ubm as TU  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bw_stats as tbw  # noqa: E402
from repro_torch.kernels import gmm_align as tga  # noqa: E402
from repro_torch.kernels import gmm_loglik as tgl  # noqa: E402
from repro_torch.kernels import gmm_rescore as tgr  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

MAX_SMEM = 232448
DS = range(1, 513)
CS = (1, 2, 5, 20, 33, 2048, 6272, 6273, 8192, 58112, 58113, 65536)


def _ks(C):
    return sorted({k for k in (1, 20, 32, 33, 64, C) if k <= C})


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_rel(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, (
        np.abs(got - want).max(), tol * scale)


def _cu_consts(name, scope=None):
    """The integer constants of csrc/<name>.cu: the file's own (each name's
    first definition; the nested namespaces come after them) or those of
    namespace ``scope``."""
    from repro_torch.analysis.check import kernel_pass
    src = kernel_pass._scope((_build.CSRC / f"{name}.cu").read_text(), scope)
    out = {}
    for k, v in re.findall(
            r"constexpr (?:int|unsigned) (\w+) = (0x[0-9a-fA-F]+|\d+)u?;",
            src):
        out.setdefault(k, int(v, 0))
    return out


# -- every shape has a form -------------------------------------------------


def test_gmm_align_takes_every_shape():
    """Every (C, D, K) of the grid, the full alignment and the rescore
    alone, has a geometry whose block fits; K > 32 past the whole-row
    blocks is the spill form, D past the pair table's room wide."""
    for D in DS:
        for C in CS:
            for K in _ks(C):
                g = tga.geometry(C, D, K)
                assert 0 < g.smem <= MAX_SMEM, (C, D, K)
                assert g.spill == (K > tga.STREAM_K and all(
                    tga.smem_bytes(C, D, False, r, w) > MAX_SMEM
                    for r in tga.BF_ROWS for w in (False, True)))
                r = tga.geometry(C, D, K, rescore_only=True)
                assert r.stream and r.smem <= MAX_SMEM and r.rows == 64
                assert g.wide == r.wide or not g.spill


def test_gmm_rescore_takes_every_shape():
    """Every (C, D, K) of the grid fits, P whole up to D = 200 and in
    strips past it, the sort's counts in device memory past C = 58,112;
    F*K >= 2**31 is the one refusal."""
    for D in DS:
        for C in CS:
            for K in _ks(C):
                g = tgr.geometry(1000, K, C, D)
                assert g.smem_bytes <= MAX_SMEM
                assert g.strip == (tgr.p_rows(D) if D <= 200 else tgr.STRIP)
                assert g.hist_global == int(C > 58112)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tgr.geometry(2 ** 31 // 64 + 1, 64, 65536, 512)
    tgr.geometry((2 ** 31 - 1) // 64, 64, 65536, 512)


def test_gmm_loglik_takes_every_d():
    """Every D up to 720: 128-frame blocks with the pair table in shared
    memory up to D = 204, the rows form past it with 128 frames a block up
    to D = 328, 64 up to 648, 32 beyond; each block fits, and the rows
    form's W positions are whole slabs of its rows' chunks."""
    for D in range(1, 721):
        g = tgl.geometry(D)
        assert g.smem <= MAX_SMEM
        assert g.smem == tgl.smem_bytes(D, g.wide, g.bm // 32)
        want = ((128, False) if D <= 204 else (128, True) if D <= 328
                else (64, True) if D <= 648 else (32, True))
        assert (g.bm, g.wide) == want, D
        if g.wide:
            K = tgl.rows_positions(D)
            chunks = sum(n for _, n in tgl.row_schedule(D))
            assert K % tgl.KS == 0 and 0 <= K - 8 * chunks < tgl.KS
    assert tgl.smem_bytes(205) > MAX_SMEM
    tgl.geometry(1320)
    with pytest.raises(ValueError, match="shared memory"):
        tgl.geometry(1321)


def test_bw_stats_takes_every_d():
    """Every D up to 720 has a form that fits, two blocks an SM: the rows
    form at the multiples of 4 up to 252, the pairs form at every other D
    (its shared memory the same at every D); the tables hold the form's
    columns in 16-bit codes; D past MAX_D is refused."""
    for D in range(1, 721):
        g = tbw.geometry(D)
        assert g.smem == tbw.smem_bytes(D) <= MAX_SMEM and g.blocks == 2
        assert g.pairs == (D % 4 != 0 or D > 252), D
        assert g.tile == (tbw.PM if g.pairs else tbw.BM)
        if D in (1, 5, 72, 252, 253, 255, 256, 512, 720):
            assert tbw.table(D).shape[0] == g.cols
    assert tbw.smem_bytes(252) == 115456 and tbw.smem_bytes(255) == 82944
    for D in (255, 512):
        t = tbw.table(D)
        assert D <= int((t & 0xFFFF).max()) == int((t >> 16).max()) <= D + 1
    tbw.geometry(tbw.MAX_D)
    with pytest.raises(ValueError, match="16-bit"):
        tbw.geometry(tbw.MAX_D + 1)


def test_paper_shapes_keep_their_forms():
    """At D = 72, C = 2048 (K = 20, 40 and C) the kernels launch as they
    did: the same blocks and shared memory, none of the new forms."""
    assert tga.geometry(2048, 72, 20) == (64, True, 109056, False, False)
    assert tga.geometry(2048, 72, 40) == (16, False, 160256, False, False)
    g = tga.geometry(2048, 72, 2048)
    assert g[:2] == (16, False) and not g.spill and not g.wide
    assert tgl.geometry(72) == (128, False, 89456)
    g = tgr.geometry(16384, 20, 2048, 72)
    assert (g.smem_bytes, g.strip, g.hist_global) == (40512, 72, 0)
    assert tbw.smem_bytes(72) == 69376


def test_new_constants_are_the_cuda_ones():
    """The wrappers' constants for the new forms are those of the .cu
    files."""
    gl = _cu_consts("gmm_loglik")
    for name in ("BM", "BN", "BK", "STAGES", "THREADS", "MAX_SMEM"):
        assert gl[name] == getattr(tgl, name), name
    rows = _cu_consts("gmm_loglik", "rows")
    assert (rows["BN"], rows["KS"], rows["STAGES"]) == (tgl.RBN, tgl.KS,
                                                       tgl.RING)
    bw = _cu_consts("bw_stats")
    for name in ("BM", "BN", "BK", "STAGES", "THREADS", "MAX_SMEM",
                 "MAX_D"):
        assert bw[name] == getattr(tbw, name), name
    pairs = _cu_consts("bw_stats", "pairs")
    assert (pairs["PM"], pairs["PB"], pairs["STAGES"]) == (tbw.PM, tbw.PB,
                                                          tbw.PSTAGES)
    ga = _cu_consts("gmm_align")
    for name in ("SEL_THREADS", "KEY_NINF", "SLOT_SPLIT", "THREADS", "NC"):
        assert ga[name] == getattr(tga, name), name
    gr = _cu_consts("gmm_rescore")
    for name in ("BP", "COLS", "STRIP", "THREADS"):
        assert gr[name] == getattr(tgr, name), name


# -- the spill form's select ------------------------------------------------


def _scores(rng, F, C, case):
    """[F, C] f32 scores rounded to a coarse grid (many exact ties), with
    one of: a NaN below C-1 in frame 1, a NaN at C-1 alone in frame 2, a
    frame with only 3 scores above -inf, signed zeros."""
    s = np.round(rng.standard_normal((F, C)) * 4) / 4
    s = s.astype(np.float32)
    if case == "nan":
        s[1, C // 3] = np.nan
        s[2, C - 1] = np.nan
    if case == "ninf":
        s[3] = -np.inf
        s[3, [0, C // 2, C - 2]] = 1.0
        s[4, C - 1] = -np.inf
    if case == "zeros":
        s[:, ::2] = 0.0
        s[:, 1::2] = -0.0
    return s


@pytest.mark.parametrize("case", ["ties", "nan", "ninf", "zeros"])
@pytest.mark.parametrize("C,K", [(300, 1), (300, 33), (300, 300),
                                 (1000, 64), (257, 257)])
def test_select_topk_is_the_argmax_rule(case, C, K):
    """The select's passes give exactly what the TPU kernel's masked
    argmax passes give (``ref.argmax_topk``): best first, ties to the
    lowest id, the NaN rule, id 0 past the scores above -inf, -0 = +0."""
    rng = np.random.default_rng(C + K)
    s = _t(_scores(rng, 12, C, case))
    np.testing.assert_array_equal(tga.select_topk(s, K).numpy(),
                                  tref.argmax_topk(s, K).numpy())


@pytest.mark.parametrize("C,K", [(300, 33), (300, 300), (1000, 64)])
def test_select_topk_matches_plain_and_lax_top_k(C, K):
    """On finite scores with ties, the select is the plain top-K (ties
    toward the lowest id) and, for K < C, ``lax.top_k`` (on the CPU, XLA
    orders the ties of a full sort, K = C, its own way)."""
    rng = np.random.default_rng(C * K)
    s = _scores(rng, 16, C, "ties")
    got = tga.select_topk(_t(s), K).numpy()
    np.testing.assert_array_equal(got, tref.topk_lowest(_t(s), K).numpy())
    if K < C:
        np.testing.assert_array_equal(got, np.asarray(
            jax.lax.top_k(jnp.asarray(s), K)[1]))


def test_order_keys_order_the_scores():
    """Keys grow with the score; -0 and +0 share a key; NaN is above
    every score; -inf's key is KEY_NINF; the radix select's threshold
    digits cover the key."""
    v = torch.tensor([-np.inf, -3e38, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1.0,
                      3e38, np.inf, np.nan], dtype=torch.float32)
    k = tga.order_keys(v[None])[0]
    assert (k[1:5] > k[:4]).all() and k[4] == k[5]
    assert (k[6:] > k[5:-1]).all() and int(k[-1]) == 0xFFFFFFFF
    assert int(k[0]) == tga.KEY_NINF
    assert int(k.max()) < 2 ** 32 and int(k.min()) >= 0


# -- the new forms' arithmetic ----------------------------------------------


@pytest.mark.parametrize("D", [1, 7, 205, 256])
def test_gmm_loglik_codes_form_the_expansion(D):
    """The 10-bit pair codes form ``ref.expand_quadratic`` bitwise (zero
    past E2), and W's product with them is ``ref.gmm_loglik``."""
    rng = np.random.default_rng(D)
    x = _t(rng.standard_normal((6, D)).astype(np.float32))
    table = tgl.pair_table(D)
    E2 = 1 + D + D * (D + 1) // 2
    assert table.shape[0] == -(-E2 // tgl.BK) * tgl.BK
    A = tgl.expansion(x, table)
    assert torch.equal(A[:, :E2], tref.expand_quadratic(x))
    assert (A[:, E2:] == 0).all()
    C = 3
    const = _t(rng.standard_normal(C).astype(np.float32))
    lin = _t(rng.standard_normal((D, C)).astype(np.float32))
    a = rng.standard_normal((C, D, D)).astype(np.float32)
    P = _t((a @ a.transpose(0, 2, 1) / D).reshape(C, D * D))
    W = tgl.packed_weights(const, lin, P)
    _close_rel(A @ W[:, :C], tref.gmm_loglik(x, const, lin, P), 2e-5)


@pytest.mark.parametrize("D", [1, 7, 235, 256])
def test_gmm_align_pair_table_forms_the_expansion(D):
    """Phase B's codes (the table the wide form reads) over a frame's row
    [x | 1 | 2x | 1] form ``ref.expand_quadratic`` bitwise."""
    rng = np.random.default_rng(D)
    x = _t(rng.standard_normal((5, D)).astype(np.float32))
    ones = torch.ones(5, 1)
    xr = torch.cat([x, ones, 2 * x, ones], 1)
    code = tga.pair_table(D).long()
    assert code.shape[0] == 1 + D + D * (D + 1) // 2
    got = xr[:, code & 0xFFFF] * xr[:, code >> 16]
    assert torch.equal(got, tref.expand_quadratic(x))


@pytest.mark.parametrize("D,strip", [(201, 32), (256, 32), (72, 72)])
def test_strip_scores_match_plain_and_jax(D, strip):
    """The strip form's sums (each strip's part of x'Px added in strip
    order) against the port's plain rescore and the JAX package's."""
    rng = np.random.default_rng(D)
    C, F, K = 6, 20, 4
    const = rng.standard_normal(C).astype(np.float32)
    lin = rng.standard_normal((D, C)).astype(np.float32)
    a = rng.standard_normal((C, D, D)).astype(np.float32)
    P = ((a @ a.transpose(0, 2, 1)) / D).reshape(C, D * D).astype(np.float32)
    x = rng.standard_normal((F, D)).astype(np.float32)
    sel = rng.integers(0, C, (F, K))
    A = tref.rescore_pack(_t(const), _t(lin), _t(P))
    got = tgr.strip_scores(_t(x), _t(sel), A, strip)
    _close_rel(got, tref.gmm_rescore(_t(x), _t(sel), _t(const), _t(lin),
                                     _t(P)), 2e-5)
    _close_rel(got, jref.gmm_rescore(jnp.asarray(x), jnp.asarray(sel),
                                     jnp.asarray(const), jnp.asarray(lin),
                                     jnp.asarray(P)), 2e-5)


@pytest.mark.parametrize("compact", [False, True])
def test_bw_moments_with_wide_codes_match_jax(compact):
    """The kernel's arithmetic with 16-bit codes at D = 256 (its form's
    table and component tiles, runs cut and compacted as on the card)
    against both packages' plain moments."""
    rng = np.random.default_rng(256)
    F, C, D = 96, 140, 256
    x = rng.standard_normal((F, D)).astype(np.float32)
    gamma = rng.dirichlet(np.ones(C), size=F).astype(np.float32)
    gamma[rng.uniform(size=(F, C)) < 0.7] = 0.0
    got = tbw.moments(_t(gamma), _t(x), tbw.table(D), 3, compact,
                      tbw.geometry(D).tile)
    want = jref.bw_stats(jnp.asarray(gamma), jnp.asarray(x))
    plain = tref.bw_stats(_t(gamma), _t(x))
    for g, w, p in zip(got, want, plain):
        _close_rel(g, w, 2e-5)
        _close_rel(g, p, 2e-5)


def _loglik_inputs(rng, F, C, D):
    """x, const, lin and a P_flat with an antisymmetric part (the kernels
    use its symmetric part, as x'Px does)."""
    x = rng.standard_normal((F, D)).astype(np.float32)
    const = rng.standard_normal(C).astype(np.float32)
    lin = rng.standard_normal((D, C)).astype(np.float32)
    a = rng.standard_normal((C, D, D)).astype(np.float32)
    P = (0.3 * a @ a.transpose(0, 2, 1) / D + np.eye(D, dtype=np.float32)
         + 0.01 * rng.standard_normal((C, D, D)).astype(np.float32))
    return x, const, lin, P.reshape(C, D * D).astype(np.float32)


@pytest.mark.parametrize("D", [205, 255, 256, 257])
def test_rows_form_sums_match_plain_and_jax(D):
    """gmm_loglik's rows form in plain tensor code (``row_sums``: each
    row's inner sum as the kernel's three TF32 products over its 8-wide
    chunks, times x_i, added in row order, const last) against the port's
    plain version and the JAX package's, 2e-5 of the largest |value|."""
    rng = np.random.default_rng(D)
    F, C = 24, 40
    x, const, lin, P = _loglik_inputs(rng, F, C, D)
    Wr = tgl.row_weights(_t(const), _t(lin), _t(P))
    assert Wr.shape == (tgl.RBN, tgl.rows_positions(D))
    got = tgl.row_sums(_t(x), _t(const), Wr)
    _close_rel(got, tref.gmm_loglik(_t(x), _t(const), _t(lin), _t(P)), 2e-5)
    _close_rel(got, jref.gmm_loglik(jnp.asarray(x), jnp.asarray(const),
                                    jnp.asarray(lin), jnp.asarray(P)), 2e-5)


@pytest.mark.parametrize("D", [7, 205, 256])
def test_row_weights_are_the_packed_weights(D):
    """Each of the rows form's positions holds the packed operand's value
    for its pair times the pair's weight (2 off the diagonal), bitwise;
    the linear row holds lin; every other position is zero."""
    rng = np.random.default_rng(D + 1)
    C = 5
    _, const, lin, P = _loglik_inputs(rng, 1, C, D)
    W = tgl.packed_weights(_t(const), _t(lin), _t(P))
    Wr = tgl.row_weights(_t(const), _t(lin), _t(P))
    assert (Wr[C:] == 0).all()
    want = torch.zeros_like(Wr[:C])
    pos = 0
    for r, (j0, n) in enumerate(tgl.row_schedule(D)):
        for k in range(8 * n):
            j = j0 + k
            if j >= D:
                continue
            if r == 0:
                want[:, pos + k] = _t(lin)[j]
            elif j >= r - 1:
                i = r - 1
                e = 1 + D + i * D - i * (i - 1) // 2 + (j - i)
                want[:, pos + k] = W[e, :C] * (1 if i == j else 2)
        pos += 8 * n
    assert torch.equal(Wr[:C], want)


def test_tf32_split_rounds_to_nearest_away():
    """hi is v rounded to 10 mantissa bits, ties away from zero; lo is v -
    hi truncated to 10 mantissa bits (as the tensor cores read it); v - hi
    - lo is below 2^-20 |v|."""
    v = torch.tensor([1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -12,
                      3.14159265, -2.71828, 1e-20, 0.0], dtype=torch.float32)
    hi, lo = tgl.tf32_split(v)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert (lo.view(torch.int32) & 0x1FFF == 0).all()
    assert hi[1].item() == 1 + 2 ** -10 and hi[2].item() == -(1 + 2 ** -10)
    assert hi[3].item() == 1 + 2 ** -10
    rest = (v.double() - hi.double() - lo.double()).abs()
    assert (rest <= 2 ** -20 * v.double().abs()).all()


@pytest.mark.parametrize("D", [205, 255, 256, 257])
@pytest.mark.parametrize("compact", [False, True])
def test_pairs_form_moments_match_plain_and_jax(D, compact):
    """bw_stats' pairs form in plain tensor code (``moments`` over
    ``pairs_table``'s (I, J) tiles and 64-component tiles, runs cut and
    compacted as on the card) against the port's plain version and the JAX
    package's, 2e-5 relative."""
    rng = np.random.default_rng(D + 7)
    F, C = 50, 150
    x = rng.standard_normal((F, D)).astype(np.float32)
    gamma = rng.dirichlet(np.ones(C), size=F).astype(np.float32)
    gamma[rng.uniform(size=(F, C)) < 0.8] = 0.0
    got = tbw.moments(_t(gamma), _t(x), tbw.pairs_table(D), 2, compact,
                      tbw.PM)
    want = jref.bw_stats(jnp.asarray(gamma), jnp.asarray(x))
    plain = tref.bw_stats(_t(gamma), _t(x))
    for g, w, p in zip(got, want, plain):
        _close_rel(g, w, 2e-5)
        _close_rel(g, p, 2e-5)


@pytest.mark.parametrize("D", [1, 5, 16, 17, 253, 256, 257, 512])
def test_pairs_table_covers_the_triangle(D):
    """Every pair i <= j < D, every f column (d, D) and n's (D, D) exactly
    once; a tile's first column is its blocks' first indices, and each
    used column's indices lie in its tile's blocks (or are D)."""
    t = tbw.pairs_table(D)
    assert t.shape[0] == tbw.pairs_columns(D) and t.dtype == torch.int32
    i, j = (t & 0xFFFF).long(), (t >> 16).long()
    used = i <= D
    assert ((i == D + 1) & (j == D + 1))[~used].all()
    got = sorted(zip(i[used].tolist(), j[used].tolist()))
    want = sorted([(a, b) for a in range(D) for b in range(a, D)]
                  + [(d, D) for d in range(D)] + [(D, D)])
    assert got == want
    tile = torch.arange(t.shape[0]) // tbw.PN
    ib, jb = i[::tbw.PN][tile], j[::tbw.PN][tile]
    assert (ib % tbw.PB == 0).all() and (ib <= jb).all()
    inside = (((i == D) | ((i >= ib) & (i < ib + tbw.PB)))
              & ((j == D) | ((j >= jb) & (j < jb + tbw.PB))))
    assert inside[used].all()


# -- the i-vector path at D = 256 and at K = C ------------------------------


def _gmm_np(seed, C, D):
    """A full-covariance GMM with SPD covariances, from ``seed``."""
    rng = np.random.default_rng(seed)
    means = (2.0 * rng.standard_normal((C, D))).astype(np.float32)
    A = (rng.standard_normal((C, D, D)) / np.sqrt(D)).astype(np.float32)
    covs = (0.3 * np.einsum("cij,ckj->cik", A, A)
            + np.eye(D, dtype=np.float32)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, C).astype(np.float32)
    return w / w.sum(), means, covs


def _frames_np(seed, gmm, F):
    """[F, D] frames drawn from the GMM."""
    w, m, c = gmm
    rng = np.random.default_rng(seed)
    comp = rng.choice(len(w), size=F, p=w)
    z = rng.standard_normal((F, m.shape[1]))
    L = np.linalg.cholesky(c.astype(np.float64))
    return (m[comp] + np.einsum("fij,fj->fi", L[comp], z)).astype(np.float32)


def _both(gmm):
    w, m, c = gmm
    return (JU.FullGMM(jnp.asarray(w), jnp.asarray(m), jnp.asarray(c)),
            convert.ubm_from_numpy(w, m, c, device="cpu"))


PATHS = [(16, 256, 4), (16, 256, 16), (32, 6, 32)]   # (C, D, K)


@pytest.mark.parametrize("C,D,K", PATHS)
@pytest.mark.parametrize("rescore", ["dense", "sparse", "fused"])
def test_align_frames_matches_jax(C, D, K, rescore):
    """Each rung at D = 256 and at K = C: the same ids, posteriors and
    per-frame log-likelihoods as the JAX package's."""
    gmm = _gmm_np(C + D, C, D)
    jubm, tubm = _both(gmm)
    x = _frames_np(1, gmm, 40)
    jp, jl = JAL.align_frames(jnp.asarray(x), jubm, jubm.to_diag(), top_k=K,
                              floor=0.025, with_loglik=True, rescore=rescore)
    tp, tl = TAL.align_frames(_t(x), tubm, tubm.to_diag(), top_k=K,
                              floor=0.025, with_loglik=True, rescore=rescore)
    np.testing.assert_array_equal(tp.indices.numpy(), np.asarray(jp.indices))
    _close_rel(tp.values, jp.values, 1e-4)
    _close_rel(tl, jl, 1e-4)


@pytest.mark.parametrize("C,D,K", PATHS)
def test_rungs_and_statistics_match_jax(C, D, K):
    """The three loglik rungs on one selection, and the statistics of a
    chunk (``chunk_body``: n, f, full S, loglik, frames) against JAX."""
    gmm = _gmm_np(C + D + 1, C, D)
    jubm, tubm = _both(gmm)
    x = _frames_np(2, gmm, 32)
    jdiag, jsel = JAL.preselect(jubm.to_diag(), jnp.asarray(x), K)
    sel = _t(jsel).long()
    for rescore in ("dense", "sparse"):
        _close_rel(TAL.rescore_selected(_t(x), sel, tubm, None,
                                        rescore=rescore),
                   JAL.rescore_selected(jnp.asarray(x), jsel, jubm, jdiag,
                                        rescore=rescore), 2e-5)
    _close_rel(TU.full_rescore_fused(tubm, _t(x), sel),
               JAL.rescore_selected(jnp.asarray(x), jsel, jubm, jdiag,
                                    rescore="fused"), 2e-5)
    feats = x.reshape(2, 16, D)
    spec = dict(n_components=C, top_k=K, floor=0.025, second_order="full",
                rescore="sparse")
    jcs = JEN.chunk_body(JEN.EngineSpec(**spec), JEN.pack_ubm(jubm),
                         jnp.asarray(feats))
    tcs = TEN.chunk_body(TEN.EngineSpec(**spec), TEN.pack_ubm(tubm, "cpu"),
                         _t(feats))
    for got, want in zip(tcs, jcs):
        _close_rel(got, want, 1e-4)


@pytest.mark.parametrize("C,D,R", [(16, 256, 8)])
def test_posterior_at_d256_matches_jax(C, D, R):
    """``tvm.posterior`` and the i-vectors at D = 256 against JAX."""
    rng = np.random.default_rng(3)
    _, m, c = _gmm_np(4, C, D)
    T = (0.1 * rng.standard_normal((C, D, R))).astype(np.float32)
    prior = np.zeros(R, np.float32)
    T[:, :, 0] = m / 10.0
    prior[0] = 10.0
    jm = JTV.TVModel(jnp.asarray(T), jnp.asarray(c), jnp.asarray(prior),
                     jnp.asarray(m), "augmented")
    tm = convert.tvm_from_numpy(T, c, prior, m, "augmented", device="cpu")
    n = rng.uniform(0.5, 5.0, (3, C)).astype(np.float32)
    f = rng.standard_normal((3, C, D)).astype(np.float32)
    jphi, jPhi = JTV.posterior(jm, JTV.precompute(jm, "packed"),
                               jnp.asarray(n), jnp.asarray(f))
    tphi, tPhi = TTV.posterior(tm, TTV.precompute(tm, "packed",
                                                  device="cpu"),
                               _t(n), _t(f))
    _close_rel(tphi, jphi, 1e-4)
    _close_rel(tPhi, jPhi, 1e-4)


@pytest.mark.parametrize("C,D,K", PATHS)
def test_train_ubm_iteration_matches_jax(C, D, K):
    """One full-covariance EM iteration of ``train_ubm`` (the engine's
    streamed statistics, then ``full_m_step``) from the same UBM, fused
    rung, at D = 256 and at train_ubm's default K = C."""
    gmm = _gmm_np(C + D + 2, C, D)
    jubm, tubm = _both(gmm)
    x = _frames_np(5, gmm, 64).reshape(4, 16, D)
    spec = dict(n_components=C, top_k=K, floor=0.0, second_order="full",
                chunk=2, rescore="fused")
    jst = JEN.stream_ubm(JEN.EngineSpec(**spec), JEN.pack_ubm(jubm),
                         jnp.asarray(x), None)
    tst = TEN.stream_ubm(TEN.EngineSpec(**spec), TEN.pack_ubm(tubm, "cpu"),
                         _t(x), None)
    for got, want in zip(tst, jst):
        _close_rel(got, want, 1e-4)
    jnew = JU.full_m_step(jst.n, jst.f, jst.ss)
    tnew = TU.full_m_step(tst.n, tst.f, tst.ss)
    for got, want in zip((tnew.weights, tnew.means, tnew.covs),
                         (jnew.weights, jnew.means, jnew.covs)):
        _close_rel(got, want, 1e-4)
