"""Parity of the PyTorch port's LM serving path (``repro_torch.models``,
``repro_torch.launch.serve``) with the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; model
params are drawn by the JAX ``api.init_params`` and carried across with
``repro_torch.convert.lm_params_from_numpy``. On the CPU the port runs the
plain versions of its two LM kernels (``ref.flash_attention``,
``ref.selective_scan``); they are held against the Pallas kernels in
interpret mode and against the JAX model code. Tolerances: 1e-5 for
layers and kernels (the same f32 products summed in another order),
2e-4 for whole models (eight layers of such differences, and the
chunked-associative JAX scan against a sequential one).
"""
import ast
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import selective_scan as jss  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import selective_scan as tss  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
TOL = 1e-5
MODEL_TOL = 2e-4
JAMBA = "jamba-v0.1-52b"
STABLELM = "stablelm-1.6b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _cfgs(arch, experts=False):
    """The f32 SMOKE config of ``arch`` in both packages, without experts
    unless asked (``tests/test_torch_moe.py`` holds the archs with
    experts)."""
    jc, tc = j_get_config(arch, smoke=True), t_get_config(arch, smoke=True)
    if jc.moe is not None and not experts:
        jc, tc = jc.with_overrides(moe=None), tc.with_overrides(moe=None)
    return jc, tc


def _params(jc, table, seed, prefix):
    """JAX-drawn params of a one-layer ``table`` and their port, both f32,
    with ``prefix`` and the layer axis stripped."""
    jp = JL.table_init(table, jax.random.fold_in(KEY, seed), jnp.float32)
    jp = {k[len(prefix):]: v[0] for k, v in jp.items()}
    return jp, convert.lm_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "float32", device="cpu")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(1)
    x = _normal(rng, 2, 5, 64, scale=3.0)
    scale, bias = _normal(rng, 64, scale=0.3), _normal(rng, 64, scale=0.3)
    if kind == "rmsnorm":
        want = JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale))
        got = TL.rmsnorm(_t(x), _t(scale))
    else:
        want = JL.layernorm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias))
        got = TL.layernorm(_t(x), _t(scale), _t(bias))
    _close(got, want)


@pytest.mark.parametrize("batched_positions", [False, True])
def test_rope_matches_jax(batched_positions):
    rng = np.random.default_rng(2)
    x = _normal(rng, 2, 48, 4, 32)
    pos = (rng.integers(0, 4096, size=(2, 48)) if batched_positions
           else np.arange(48)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = TL.rope(_t(x), _t(pos), 10000.0)
    # angles up to 4096 rad: cos/sin of two libraries differ by ~1 ulp of
    # the angle there
    _close(got, want, tol=4 * TOL if batched_positions else TOL)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches_jax(variant):
    jc, tc = _cfgs(STABLELM)
    jc = jc.with_overrides(mlp_variant=variant)
    tc = tc.with_overrides(mlp_variant=variant)
    jp, tp = _params(jc, JL.mlp_table(jc, "mlp", 1), 3, "mlp/")
    x = _normal(np.random.default_rng(3), 2, 7, jc.d_model)
    _close(TL.mlp(tc, tp, _t(x)), JL.mlp(jc, jp, jnp.asarray(x)))


@pytest.mark.parametrize("arch", [STABLELM, JAMBA])
def test_qkv_and_out_proj_match_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, JL.attn_table(jc, "attn", 1), 4, "attn/")
    x = _normal(np.random.default_rng(4), 2, 9, jc.d_model)
    pos = np.arange(9, dtype=np.int32)
    want = JL.qkv_proj(jc, jp, jnp.asarray(x), jnp.asarray(pos))
    got = TL.qkv_proj(tc, tp, _t(x), _t(pos))
    for g, w in zip(got, want):
        _close(g, w)
    _close(TL.out_proj(tp, got[0]), JL.out_proj(jp, want[0]))


# ---------------------------------------------------------------------------
# Attention: plain version vs the JAX paths and the Pallas kernel
# ---------------------------------------------------------------------------


def _qkv(B, S, H, KVH, hd, seed):
    rng = np.random.default_rng(seed)
    return (_normal(rng, B, S, H, hd), _normal(rng, B, S, KVH, hd),
            _normal(rng, B, S, KVH, hd))


@pytest.mark.parametrize("H,KVH", [(4, 2), (4, 4)])
def test_attention_matches_jax_blockwise_and_pallas(H, KVH):
    """(B 2, S 64, hd 16): the port's attention on the CPU against JAX's
    blockwise attention and the Pallas kernel in interpret mode, at
    G = 2 and G = 1."""
    q, k, v = _qkv(2, 64, H, KVH, 16, seed=H * KVH)
    got = TL.blockwise_causal_attention(_t(q), _t(k), _t(v))
    assert got.shape == q.shape and got.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, JL.blockwise_causal_attention(jq, jk, jv))
    _close(got, jfa.flash_attention(jq, jk, jv, block_q=32, block_k=16,
                                    interpret=True))


def test_attention_ragged_seq_matches_jax_ref():
    """S = 40 is no multiple of any block: the port takes any S."""
    q, k, v = _qkv(2, 40, 4, 2, 16, seed=40)
    got = tops.flash_attention(_t(q), _t(k), _t(v))
    _close(got, jref.flash_attention(*(jnp.asarray(a) for a in (q, k, v))))


# ---------------------------------------------------------------------------
# Selective scan: plain version vs the Pallas kernel and the JAX scan
# ---------------------------------------------------------------------------


def _scan_inputs(B, T, di, ds, seed):
    """Inputs as ``mamba_mix`` makes them: dt > 0 (softplus), A < 0."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(_normal(rng, B, T, di) - 2.0)).astype(np.float32)
    dx = dt * _normal(rng, B, T, di)
    A = -np.exp(_normal(rng, di, ds, scale=0.5))
    return dt, dx, A, _normal(rng, B, T, ds), _normal(rng, B, T, ds)


def test_selective_scan_matches_pallas():
    dt, dx, A, Bc, Cc = _scan_inputs(2, 64, 32, 8, seed=5)
    want = jss.selective_scan(*(jnp.asarray(a) for a in (dt, dx, A, Bc, Cc)),
                              block_t=32, block_d=16, interpret=True)
    y, h = tops.selective_scan(*(_t(a) for a in (dt, dx, A, Bc, Cc)))
    assert y.shape == dt.shape and h.shape == (2, 32, 8)
    _close(y, want)


def test_selective_scan_with_state_matches_jax_scan():
    """A nonzero h0 over two of the JAX scan's 64-step chunks: y and the
    last state."""
    dt, dx, A, Bc, Cc = _scan_inputs(2, 128, 24, 8, seed=6)
    h0 = _normal(np.random.default_rng(7), 2, 24, 8)
    want_y, want_h = JMB._ssm_scan(
        *(jnp.asarray(a) for a in (dt, dx, A, Bc, Cc, h0)))
    y, h = tref.selective_scan(*(_t(a) for a in (dt, dx, A, Bc, Cc, h0)))
    _close(y, want_y)
    _close(h, want_h)


@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("T", [64, 37])   # 37: ragged to 16-step chunks
@pytest.mark.parametrize("with_state", [False, True])
def test_scan_lanes_matches_pallas_and_plain(ds, T, with_state):
    """The CUDA scan's arithmetic (``scan_lanes``: exp2 of dt (A log2 e),
    each lane's partial C.h over its states, the lanes' partials added as
    the xor shuffles add them) against the Pallas kernel in interpret mode
    (no h0; it starts from zeros) or the JAX model's scan (with h0), and
    against the port's plain version, y and the last state."""
    dt, dx, A, Bc, Cc = _scan_inputs(2, T, 24, ds, seed=ds + T)
    h0 = _normal(np.random.default_rng(T), 2, 24, ds) if with_state else None
    y, h = tss.scan_lanes(*(_t(a) for a in (dt, dx, A, Bc, Cc)),
                          None if h0 is None else _t(h0))
    wy, wh = tref.selective_scan(*(_t(a) for a in (dt, dx, A, Bc, Cc)),
                                 None if h0 is None else _t(h0))
    _close(y, wy)
    _close(h, wh)
    if with_state:
        jy, jh = JMB._ssm_scan(*(jnp.asarray(a)
                                 for a in (dt, dx, A, Bc, Cc, h0)))
        _close(h, jh)
    else:
        jy = jss.selective_scan(*(jnp.asarray(a) for a in (dt, dx, A, Bc, Cc)),
                                block_t=T, block_d=8, interpret=True)
    _close(y, jy)


def test_scan_lanes_split_d_state_over_lanes():
    """Lanes per channel as a function of d_state: two at Jamba's 8 and 16,
    one at 4 and four above, so that each lane holds 4 to 16 states (a
    multiple of 4: float4 reads), every state on exactly one lane; every
    d_state from 1 to 256 takes its instance's lanes (past 64 the 64-state
    instance's, one instance a group of 64), and one past 256 is refused,
    naming the range."""
    assert [tss.lanes(ds) for ds in tss.INSTANCES] == [1, 2, 2, 4, 4]
    for ds in tss.INSTANCES:
        L = tss.lanes(ds)
        assert ds % L == 0 and 4 <= ds // L <= 16 and (ds // L) % 4 == 0
        assert 32 % L == 0                  # a channel's lanes share a warp
    for ds in tss.D_STATES:
        assert tss.lanes(ds) == tss.lanes(tss.instance(ds))
        n = tss.instance(ds)
        if ds <= 64:
            assert ds <= n and (n == 4 or n < 2 * ds)
        else:
            assert n == 64 and tss.groups(ds) == -(-ds // 64)
    for ds in (0, 257, 300):
        with pytest.raises(ValueError, match=r"d_state 1 to 256"):
            tss.lanes(ds)


def test_scan_d_states_are_the_cuda_instances():
    """``INSTANCES`` lists exactly the d_states the dispatch of
    csrc/selective_scan.cu has an instance for, ``D_STATES`` (1 to 256) the
    d_states it takes, and ``lanes`` is the kernel's ``lanes`` there
    (checked on the card by chip_smoke.py through ``selective_scan_lanes``
    and ``selective_scan_geometry``)."""
    src = (_build.CSRC / "selective_scan.cu").read_text()
    body = src[src.index('extern "C" int selective_scan_f32('):]
    cases = tuple(int(n) for n in re.findall(r"SSF_CASE\((\d+)\)", body))
    assert cases == tss.INSTANCES
    assert tss.D_STATES == tuple(range(1, 257))
    expr = re.search(r"constexpr int lanes\(int ds\) \{\s+return ([^;]+);",
                     src).group(1)
    assert expr == "ds == 4 ? 1 : ds <= 16 ? 2 : 4"


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_mix_matches_jax(with_state):
    jc, tc = _cfgs(JAMBA)
    jp, tp = _params(jc, JMB.mamba_table(jc, "m", 1), 8, "m/")
    rng = np.random.default_rng(8)
    x = _normal(rng, 2, 12, jc.d_model)
    di, _, ds, dc = JMB.dims(jc)
    state = ((_normal(rng, 2, dc - 1, di), _normal(rng, 2, di, ds))
             if with_state else None)
    jstate = None if state is None else tuple(jnp.asarray(a) for a in state)
    tstate = None if state is None else tuple(_t(a) for a in state)
    want_y, (want_tail, want_h) = JMB.mamba_mix(jc, jp, jnp.asarray(x),
                                                jstate)
    got_y, (got_tail, got_h) = TMB.mamba_mix(tc, tp, _t(x), tstate)
    _close(got_y, want_y)
    _close(got_tail, want_tail)
    _close(got_h, want_h)


# ---------------------------------------------------------------------------
# Whole models: prefill and decode against JAX
# ---------------------------------------------------------------------------


def _model(arch, seed):
    jc, tc = _cfgs(arch)
    jp = japi.init_params(jc, jax.random.fold_in(KEY, seed))
    tp = convert.lm_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "float32", device="cpu")
    return jc, tc, jp, tp


def test_jamba_prefill_and_decode_match_jax():
    """Jamba SMOKE without experts (8 layers: 1 attention, 7 Mamba, f32):
    prefill logits, then step-by-step decode from a zero cache, every
    step's logits against JAX's."""
    jc, tc, jp, tp = _model(JAMBA, 10)
    B, S = 2, 12
    tokens = np.random.default_rng(10).integers(0, jc.vocab_size, (B, S))
    tokens = tokens.astype(np.int32)
    jcache, jlog = jax.jit(japi.make_prefill_step(jc))(
        jp, {"tokens": jnp.asarray(tokens)})
    tcache, tlog = tapi.make_prefill_step(tc)(tp, {"tokens": _t(tokens)})
    assert jcache is None and tcache is None
    _close(tlog, jlog, MODEL_TOL)

    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in
              japi.cache_specs(jc, JShape("t", S, B, "decode"))[0].items()}
    tcache = tapi.zero_cache(tc, TShape("t", S, B, "decode"), "cpu")
    jdec = jax.jit(japi.make_decode_step(jc))
    tdec = tapi.make_decode_step(tc)
    for t in range(S):
        jcache, jlog = jdec(jp, jcache, {"token": jnp.asarray(tokens[:, t]),
                                         "pos": jnp.asarray(t, jnp.int32)})
        tcache, tlog = tdec(tp, tcache, {"token": _t(tokens[:, t]),
                                         "pos": t})
        _close(tlog, jlog, MODEL_TOL)
    for k in ("k", "v", "conv", "h"):
        _close(tcache[k], jcache[k], MODEL_TOL)


def test_stablelm_prefill_and_decode_match_jax():
    """StableLM SMOKE (2 layers, LayerNorm, MHA, f32): prefill of S-1
    tokens and its cache, ``pad_cache`` to S, one decode step; the decode
    logits also agree with the full prefill's."""
    jc, tc, jp, tp = _model(STABLELM, 11)
    B, S = 2, 16
    tokens = np.random.default_rng(11).integers(0, jc.vocab_size, (B, S))
    tokens = tokens.astype(np.int32)
    jpre = jax.jit(japi.make_prefill_step(jc))
    tpre = tapi.make_prefill_step(tc)
    jcache, jlog = jpre(jp, {"tokens": jnp.asarray(tokens[:, :-1])})
    tcache, tlog = tpre(tp, {"tokens": _t(tokens[:, :-1])})
    _close(tlog, jlog, MODEL_TOL)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k], MODEL_TOL)
    jcache = jserve.pad_cache(jcache, S)
    tcache = tserve.pad_cache(tcache, S)
    assert tcache["k"].shape == jcache["k"].shape
    batch = {"token": tokens[:, -1], "pos": S - 1}
    _, jlog = japi.make_decode_step(jc)(
        jp, jcache, {"token": jnp.asarray(batch["token"]),
                     "pos": jnp.asarray(S - 1, jnp.int32)})
    _, tlog = tapi.make_decode_step(tc)(
        tp, tcache, {"token": _t(batch["token"]), "pos": S - 1})
    _close(tlog, jlog, MODEL_TOL)
    _, full = tpre(tp, {"tokens": _t(tokens)})
    _close(tlog, full, 2e-3)


@pytest.mark.parametrize("arch,experts", [
    pytest.param(STABLELM, False, id=STABLELM),
    pytest.param(JAMBA, False, id=JAMBA),
    pytest.param(JAMBA, True, id=JAMBA + "-experts")])
def test_full_config_tables_match_jax(arch, experts):
    """At the published widths, without allocating: the same parameter
    count, decode cache shapes and Mamba state shapes as the JAX
    package; Jamba without its experts and with them."""
    jc, tc = j_get_config(arch), t_get_config(arch)
    if jc.moe is not None and not experts:
        jc, tc = jc.with_overrides(moe=None), tc.with_overrides(moe=None)
    assert tapi.n_params(tc) == japi.n_params(jc)
    want = {k: (tuple(s.shape), str(s.dtype)) for k, s in
            japi.cache_specs(jc, JShape("t", 2064, 4, "decode"))[0].items()}
    got = {k: (tuple(s), str(d).replace("torch.", "")) for k, (s, d) in
           tapi.cache_specs(tc, TShape("t", 2064, 4, "decode")).items()}
    assert got == want
    if jc.ssm is not None:
        jstate, _ = JMB.state_struct(jc, 4, jnp.bfloat16, 4)
        tstate = TMB.state_struct(tc, 4, torch.bfloat16, 4)
        assert {k: tuple(v.shape) for k, v in jstate.items()} == {
            k: shape for k, (shape, _) in tstate.items()}


# ---------------------------------------------------------------------------
# Refusals, the serving launcher, import isolation
# ---------------------------------------------------------------------------


def test_jamba_with_experts_raises():
    """(Named while Jamba with experts raised; the name is kept so that its
    record carries on.) Jamba with its experts runs: its SMOKE param table
    is the reference's (an MoE in every odd slot, a dense MLP in the
    others) and a prefill from the port's own draw gives finite logits."""
    jc, tc = _cfgs(JAMBA, experts=True)
    assert tc.moe is not None
    jt, tt = japi.param_table(jc), tapi.param_table(tc)
    assert {k: v[0] for k, v in jt.items()} == {k: v[0]
                                                for k, v in tt.items()}
    assert {k.split("/")[1] for k in tt if "/moe/" in k} == {
        "s1", "s3", "s5", "s7"}
    params = tapi.init_params(tc, torch.Generator().manual_seed(0),
                              device="cpu")
    cache, logits = tapi.make_prefill_step(tc)(
        params, {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    assert cache is None and torch.isfinite(logits).all()


def test_unported_arch_raises():
    """(Named while the MoE archs raised; the name is kept so that its
    record carries on.) Every LM arch resolves; an arch id the package
    does not know raises, naming the ones it has."""
    assert t_get_config("arctic-480b").moe.n_experts == 128
    with pytest.raises(KeyError, match="moonshot-v1-16b-a3b"):
        t_get_config("mixtral-8x7b")


def test_init_params_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _cfgs(STABLELM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.init_params(tc, torch.Generator())


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch only on the card; a CPU tensor takes the plain
    version through ``ops``, never the wrapper."""
    q, k, v = (_t(a) for a in _qkv(1, 8, 2, 2, 16, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v)
    dt, dx, A, Bc, Cc = (_t(a) for a in _scan_inputs(1, 4, 8, 16, seed=0))
    with pytest.raises(ValueError, match="CUDA"):
        tss.selective_scan(dt, dx, A, Bc, Cc)
    # the kernel takes d_state 1 to 256 only
    dt, dx, A, Bc, Cc = (_t(a) for a in _scan_inputs(1, 4, 8, 257, seed=0))
    with pytest.raises(ValueError, match="d_state"):
        tss.selective_scan(dt, dx, A, Bc, Cc)
    assert tfa.flash_attention.launches == 0
    assert tss.selective_scan.launches == 0
    assert {"flash_attention", "selective_scan"} <= set(_build.SIGNATURES)


@pytest.mark.parametrize("arch", [STABLELM, JAMBA])
def test_serve_on_cpu(arch):
    """``serve`` at SMOKE size on the CPU: ``gen`` tokens per row, finite
    logits, the same result from the same seed, and the first generated
    token is the argmax of the prefill logits. A hybrid is refused, as the
    JAX launcher refuses it: Jamba's prefill returns no cache."""
    _, tc = _cfgs(arch)
    if tc.family == "hybrid":
        with pytest.raises(NotImplementedError, match="hybrid"):
            tserve.serve(tc, 2, 10, 4, torch.Generator().manual_seed(3),
                         "cpu")
        return
    runs = [tserve.serve(tc, 2, 10, 4, torch.Generator().manual_seed(3),
                         "cpu") for _ in range(2)]
    r = runs[0]
    assert r["tokens"].shape == (2, 4)
    assert torch.isfinite(r["last_logits"]).all()
    assert torch.equal(r["tokens"], runs[1]["tokens"])
    assert torch.equal(r["tokens"][:, 0],
                       torch.argmax(r["prefill_logits"], -1))


def test_serve_main_with_the_jax_flags(monkeypatch, capsys):
    """``main`` takes the JAX launcher's flags and runs on the card; here
    its device is the CPU."""
    monkeypatch.setattr(tserve, "resolve_device",
                        lambda device=None: torch.device("cpu"))
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", STABLELM, "--smoke", "--batch", "2",
        "--prompt-len", "8", "--gen", "3"])
    tserve.main()
    out = capsys.readouterr().out
    assert "prefill: 2x8" in out and "decode: 2 steps" in out


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 30 and not bad, bad
