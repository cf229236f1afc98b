"""The port's attention at every head dim from 1 to 512 against the JAX
package, on the CPU.

The kernels take any head dim from 1 to 512 in f32 and bf16, forward and
backward (``kernels/flash_attention.py``: bf16 on the tensor-core
instance of its width, staged ``ld(hd)`` columns wide where hd is not a
multiple of 8; f32 on the CUDA-core instance of its width; the columns
past hd zero).
On the CPU the port runs the plain version (``ref.flash_attention``) and
the backward kernels' algorithm (``backward_blocks``, at the kernels'
tile rows of the head dim); here they are held against the Pallas kernel
in interpret mode, ``blockwise_causal_attention`` and ``jax.grad`` of the
JAX reference attention, and StableLM SMOKE at head_dim 40 and 320 and
Whisper SMOKE at 33 (no RoPE, so an odd head dim) against JAX at model
level. Inputs are made with numpy from a seed. Limits:

- TOL, f32 against f32: 1e-5 x max|want| (the same f32 function summed
  in another order), as ``tests/test_torch_lm.py``.
- BF16_TOL, bf16 inputs: 2^-7 x max|want| (each result rounded once to
  bf16; the reference rounds p to bf16 before P.V, the port does not).
- MODEL_TOL, 2e-4, and GRAD_TOL, 1e-4 x each leaf's max|value|, for the
  SMOKE models (``tests/test_torch_zoo.py``'s and
  ``tests/test_torch_moe.py``'s).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402

KEY = jax.random.PRNGKey(0)
TOL = 1e-5
BF16_TOL = 2.0 ** -7
MODEL_TOL = 2e-4
GRAD_TOL = 1e-4
HEAD_DIMS = (1, 8, 33, 40, 72, 100, 160, 257, 320, 512)
SMEM = 232448
bf16 = torch.bfloat16


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _qkv(hd, S, dtype, seed, B=1, H=4, KVH=2, do=False):
    """q, k, v (and dO) as numpy f32 holding values of ``dtype``."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((B, S, n, hd)).astype(np.float32)
           for n in (H, KVH, KVH) + ((H,) if do else ())]
    if dtype == "bfloat16":
        out = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
               for a in out]
    return out


# ---------------------------------------------------------------------------
# The kernels' functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_attention_matches_pallas_and_blockwise(hd, dtype):
    """The port's attention at the head dim (``ops.flash_attention``: the
    plain version on the CPU) against the Pallas kernel in interpret mode
    (one block of S rows: its own tiling is not what is held here) and
    ``blockwise_causal_attention``, on the same inputs in the type; S 64
    (128 at hd 100 and 257), B 1, H 4, KVH 2."""
    S = 128 if hd in (100, 257) else 64
    q, k, v = _qkv(hd, S, dtype, seed=hd)
    tt = getattr(torch, dtype)
    got = tops.flash_attention(*(torch.as_tensor(a).to(tt)
                                 for a in (q, k, v)))
    assert got.dtype == tt and got.shape == q.shape
    jt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(a, jt) for a in (q, k, v))
    tol = TOL if dtype == "float32" else BF16_TOL
    assert _rel(got, jfa.flash_attention(jq, jk, jv, block_q=S, block_k=S,
                                         interpret=True)) <= tol
    assert _rel(got, jax.jit(JL.blockwise_causal_attention)(jq, jk, jv)) \
        <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_backward_blocks_match_jax_grad(hd, dtype):
    """``backward_blocks`` at the kernels' tile rows of the head dim
    (``bwd_rows``: on the CUDA cores 64 up to 128, 32 up to 384, 16
    above; 128 up to 128 on the tensor cores, 64 above), with
    ``lse_blocks`` at the forward's (``kv_rows``: 32 on the width-512
    instance), against ``jax.grad`` of
    the JAX package's reference attention (``repro.kernels.ref``) in f32
    on the same values: TOL in f32,
    BF16_TOL on bf16 inputs (P and dS as bf16 hi + lo where the tensor
    cores take them). o is the plain forward's f32 output: the kernels
    read the forward's bf16 o, whose rounding moves Delta = rowsum(dO o)
    by up to 2^-9 of it (at hd 1, one term a row, 1.0e-2 of max|grad| here
    against 2^-7); chip_smoke.py holds the kernels against
    ``backward_blocks`` on that same bf16 o."""
    S = 48
    q, k, v, do = _qkv(hd, S, dtype, seed=hd + 1, do=True)
    _, vjp = jax.vjp(jref.flash_attention,
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tt = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.as_tensor(a).to(tt) for a in (q, k, v, do))
    block = tfa.bwd_rows(tt, hd)
    o = tref.flash_attention(tq.float(), tk.float(), tv.float())
    got = tfa.backward_blocks(tq, tk, tv, o,
                              tfa.lse_blocks(tq, tk, tfa.kv_rows(tt, hd)),
                              tdo, block)
    tol = TOL if dtype == "float32" else BF16_TOL
    for a, w in zip(got, want):
        assert a.dtype == tt
        assert _rel(a, w) <= tol


# ---------------------------------------------------------------------------
# The launch geometry and the domain
# ---------------------------------------------------------------------------


def _width_fn(scope: str, src: str):
    """``width(hd)`` of namespace ``scope`` of a .cu source as a Python
    function: the C chain of conditionals read from the source (``c1 ? v1
    : c2 ? v2 : .. : d``, integer arithmetic, ``||`` and ``&&``)."""
    body = src[src.index(f"namespace {scope} {{"):]
    expr = re.search(r"constexpr int width\(int hd\) \{\s+return ([^;]+);",
                     body).group(1)
    expr = (" ".join(expr.split()).replace("||", " or ")
            .replace("&&", " and ").replace("/", "//"))
    parts = [p.strip() for p in re.split(r"[?:]", expr)]
    arms, default = list(zip(parts[:-1:2], parts[1::2])), parts[-1]

    def width(hd: int) -> int:
        for cond, val in arms:
            if eval(cond, {}, {"hd": hd}):
                return eval(val, {}, {"hd": hd})
        return eval(default, {}, {"hd": hd})
    return width


def test_geometry_fits_and_routes_as_the_dispatch():
    """At every head dim from 1 to 512 in both types, forward and backward:
    bf16 goes to the tensor cores, on the instance of ``tc::width`` of its
    .cu source (never 0 in the domain), and f32 to the CUDA cores, on the
    instance of ``simt::width``; every instance's block fits the card's
    232,448 bytes of shared memory; the rows and shared memory follow the
    CUDA-side formulas of the instance (namespace wide past 256)."""
    fsrc = (_build.CSRC / "flash_attention.cu").read_text()
    bsrc = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    f_tc, f_simt = _width_fn("tc", fsrc), _width_fn("simt", fsrc)
    b_tc, b_simt = _width_fn("tc", bsrc), _width_fn("simt", bsrc)
    for hd in tfa.HEAD_DIMS:
        assert tfa.route(bf16, hd) == tfa.bwd_scope(bf16, hd) == "tc"
        assert tfa.route(torch.float32, hd) == "simt"
        assert tfa.bwd_scope(torch.float32, hd) == "simt"
        assert tfa.staged(bf16, hd) == (hd % 8 != 0)
        assert tfa.staged(torch.float32, hd) == (hd % 4 != 0)
        for dt in (torch.float32, bf16):
            tc = dt == bf16
            route, width, rows, smem = tfa.geometry(dt, hd)
            assert (route, width) == ((1, f_tc(hd)) if tc
                                      else (0, f_simt(hd)))
            assert width >= tfa.ld(hd) if tc else width >= hd
            if tc:
                assert rows == (128 if width <= 192 else 64)
                kv = 128 if width <= 128 else 64 if width <= 256 else 32
                vw = width // 2 if width == 512 else width
                assert smem == (rows * width * 2 + tfa.TC_STAGES * kv
                                * (width + vw) * 2
                                + (2 * tfa.TC_STAGES + 1) * 8 + 1024)
            else:
                # 128-row blocks up to width 128, 64 above; the ring of 3
                # slabs of [128][36] floats, P [rows][132], a row's
                # rescale and the resident q tile, ld in whole 32-column
                # slabs and 4 more
                n4 = -(-hd // 4) * 4
                qld = -(-n4 // 32) * 32 + 4
                assert rows == (128 if width <= 128 else 64)
                assert width % 32 == 0
                assert smem == 4 * (3 * 128 * 36 + rows * (132 + 1 + qld))
            assert 0 < smem <= SMEM
            route, width, rows, smem = tfa.bwd_geometry(dt, hd)
            assert (route, width) == ((1, b_tc(hd)) if tc
                                      else (0, b_simt(hd)))
            if tc:
                assert width != 192 and width >= tfa.ld(hd)
                assert rows == (128 if width <= 128 else 64)
                bq = 64 if width <= 64 else 32 if width <= 256 else 16
                st = 4 if width <= 256 else 3
                assert smem == (2 * rows * width * 2 + 2 * st * bq * width
                                * 2 + (2 * st + 1) * 8 + 1024)
            else:
                # 128 key rows up to width 64, 64 above; the gradients'
                # columns in one slice up to 256, two above; the ring of 3
                # slabs of [256][20] floats, P and dS [rows][132], and on
                # 64-row blocks up to ld 192 the resident k and v tiles
                n = 1 if hd <= 256 else 2
                n4 = -(-hd // 4) * 4
                assert rows == (128 if width <= 64 else 64)
                kv = (2 * 64 * (-(-n4 // 32) * 32 + 4)
                      if n4 <= 192 and rows == 64 else 0)
                assert width <= 256 and n * width >= hd
                assert (n - 1) * 256 < n4
                # the dQ kernel's block fits the card too
                assert 0 < tfa.dq_smem_bytes(hd) <= SMEM
                assert smem == 4 * (3 * 256 * 20 + 2 * rows * 132 + kv)
            assert 0 < smem <= SMEM
    assert f_tc(513) == f_simt(513) == b_tc(513) == b_simt(513) == 0
    assert f_tc(0) == b_tc(0) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [1, 33, 100, 257, 300])
def test_staged_operands_give_the_unstaged_attention(hd, dtype):
    """The staging of a launch, on the plain version: q, k and v copied
    ``ld(hd, dtype)`` columns wide (a multiple of 8 in bf16, of 4 in f32;
    zeros past hd, ``stage``) through
    ``ref.flash_attention`` with the true head dim's scale, then narrowed,
    equal the unstaged attention to TOL (the zeros add nothing to any
    product; only the sums' order may move), forward and, through
    autograd of the staging and the narrowing, the gradients of q, k and
    v. Without the true scale the staged result is another function."""
    S = 40
    q, k, v, do = _qkv(hd, S, dtype, seed=hd + 7, do=True)
    tt = getattr(torch, dtype)
    w = tfa.ld(hd, tt)
    ins = [torch.as_tensor(a).to(tt).requires_grad_() for a in (q, k, v)]
    want = tref.flash_attention(*ins)
    staged = tref.flash_attention(*(tfa.stage(t, w) for t in ins),
                                  scale=hd ** -0.5)
    assert staged.shape[-1] == w
    got = staged[..., :hd]
    assert _rel(got.float(), want.float().detach().numpy()) <= TOL
    dout = torch.as_tensor(do).to(tt)
    gw = torch.autograd.grad(want, ins, dout)
    gg = torch.autograd.grad(got, ins, dout)
    for a, b in zip(gg, gw):
        assert a.shape == b.shape
        assert _rel(a.float(), b.float().numpy()) <= TOL
    if w != hd:
        assert tfa.stage(ins[0], w)[..., hd:].abs().max() == 0
        wrong = tref.flash_attention(*(tfa.stage(t, w) for t in ins))
        assert _rel(wrong[..., :hd].float(),
                    want.float().detach().numpy()) > TOL


@pytest.mark.parametrize("dtype", [torch.float32, bf16])
def test_past_the_domain_raises_naming_it(dtype):
    """hd 513 raises in both wrappers and in the routing, naming the
    domain, before any device is touched; hd 512 is refused only for
    lying on the CPU."""
    for hd, match in ((513, "head_dim 1 to 512, not 513"), (512, "CUDA")):
        q = torch.zeros(1, 8, 2, hd, dtype=dtype)
        k = torch.zeros(1, 8, 1, hd, dtype=dtype)
        lse = torch.zeros(1, 2, 8)
        with pytest.raises(ValueError, match=match):
            tfa.flash_attention(q, k, k)
        with pytest.raises(ValueError, match=match):
            tfa.flash_attention_bwd(q, k, k, q, lse, q)
    for fn in (tfa.route, tfa.bwd_scope, tfa.geometry, tfa.bwd_geometry):
        with pytest.raises(ValueError, match="head_dim 1 to 512"):
            fn(dtype, 513)
    assert tfa.flash_attention.launches == 0
    assert tfa.flash_attention_bwd.launches == 0


# ---------------------------------------------------------------------------
# Models at overridden head dims
# ---------------------------------------------------------------------------


def _inputs(jc, B, S, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)}
    if jc.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, jc.encoder.n_frames, jc.encoder.frontend_dim)).astype(
            np.float32)
    return out


@pytest.mark.parametrize("arch,hd", [("stablelm-1.6b", 40),
                                     ("stablelm-1.6b", 320),
                                     ("whisper-large-v3", 33)])
def test_model_prefill_and_grads_match_jax(arch, hd):
    """The f32 SMOKE config with ``head_dim`` overridden (Whisper's odd
    one: it has no RoPE), JAX-drawn params carried across: the prefill's
    logits within MODEL_TOL, ``loss_fn`` within MODEL_TOL and the gradient
    of every param leaf within GRAD_TOL x its max|value| of
    ``jax.value_and_grad``'s."""
    jc = j_get_config(arch, smoke=True).with_overrides(head_dim=hd)
    tc = t_get_config(arch, smoke=True).with_overrides(head_dim=hd)
    assert tc.resolved_head_dim() == hd
    jp = japi.init_params(jc, jax.random.fold_in(KEY, hd))
    tp = convert.lm_params_from_numpy({k: np.asarray(v) for k, v in
                                       jp.items()}, "float32", device="cpu")
    b = _inputs(jc, 2, 16, hd)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    _, jlog = jax.jit(japi.make_prefill_step(jc))(jp, jb)
    _, tlog = tapi.make_prefill_step(tc)(tp, tb)
    assert _rel(tlog, jlog) <= MODEL_TOL
    b["labels"] = np.roll(b["tokens"], -1, axis=1)
    jb["labels"], tb["labels"] = (jnp.asarray(b["labels"]),
                                  torch.as_tensor(b["labels"]))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: japi.loss_fn(jc, p, jb)))(
        jp)
    names = sorted(tp)
    leaves = [tp[k].requires_grad_() for k in names]
    tl = tapi.loss_fn(tc, dict(zip(names, leaves)), tb)
    tg = torch.autograd.grad(tl, leaves)
    assert _rel(tl, jl) <= MODEL_TOL
    for k, g in zip(names, tg):
        assert _rel(g, jg[k]) <= GRAD_TOL, k
