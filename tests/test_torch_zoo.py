"""Parity of the port's LM zoo beyond StableLM and Jamba with the JAX
package, on the CPU: Phi-3-medium, Nemotron-4 and Gemma 2B (dense),
Whisper large-v3 (audio), InternVL2-1B (vlm) and RWKV-6 7B (ssm).

Inputs are made with numpy from a seed and fed to both packages; model
params are drawn by the JAX ``api.init_params`` (with ``max_seq`` for
whisper's positional table) and carried across with
``convert.lm_params_from_numpy``. Everything runs at the f32 SMOKE
configs. Tolerances: 1e-5 for layers (the same f32 products summed in
another order) and, as ``tests/test_torch_lm.py`` holds whole models,
2e-4 for prefill, decode and the loss (a few layers of such
differences). The chunked RWKV form is held to its own stepwise form
within 2e-3, the JAX ``test_rwkv_chunked_matches_stepwise`` limit. On
the CPU the port's causal attention is the plain version of the
flash-attention kernel; at head dim 256 (Gemma 2B) it is held against
the Pallas kernel in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig as JShape  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rwkv as JRK  # noqa: E402
from repro.models import vlm as JVL  # noqa: E402
from repro.models import whisper as JWH  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, PORTED_ARCH_IDS  # noqa: E402
from repro_torch.configs import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import rwkv as TRK  # noqa: E402
from repro_torch.models import vlm as TVL  # noqa: E402
from repro_torch.models import whisper as TWH  # noqa: E402

KEY = jax.random.PRNGKey(0)
TOL = 1e-5
MODEL_TOL = 2e-4
STEP_TOL = 2e-3
PHI3, NEMOTRON, GEMMA = "phi3-medium-14b", "nemotron-4-15b", "gemma-2b"
WHISPER, INTERNVL, RWKV = "whisper-large-v3", "internvl2-1b", "rwkv6-7b"
NEW = (PHI3, NEMOTRON, GEMMA, WHISPER, INTERNVL, RWKV)
# whisper's learned decoder positions: the tests' longest window
MAX_SEQ = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _cfgs(arch):
    return j_get_config(arch, smoke=True), t_get_config(arch, smoke=True)


def _model(arch, seed):
    """JAX-drawn f32 SMOKE params of ``arch`` and their port."""
    jc, tc = _cfgs(arch)
    jp = japi.init_params(jc, jax.random.fold_in(KEY, seed), max_seq=MAX_SEQ)
    tp = convert.lm_params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "float32", device="cpu")
    return jc, tc, jp, tp


def _inputs(jc, B, S, seed):
    """The step batch of ``jc``'s family as numpy: tokens, and frames or
    patches."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, jc.vocab_size, (B, S)).astype(np.int32)}
    if jc.family in ("audio", "vlm"):
        key = "frames" if jc.family == "audio" else "patches"
        out[key] = _normal(rng, B, jc.encoder.n_frames,
                           jc.encoder.frontend_dim)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: _t(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def test_eight_lm_archs_resolve_and_only_moe_raises():
    """(The name is the one this test had while the MoE archs raised; it
    is kept so that its record carries on.) All ten LM archs resolve,
    full and SMOKE; an unknown id raises."""
    lm = [a for a in ARCH_IDS if a != "ivector-tvm"]
    assert len(lm) == 10 and set(PORTED_ARCH_IDS) == set(lm)
    for arch in lm:
        assert t_get_config(arch).arch_id == arch
        assert t_get_config(arch, smoke=True).arch_id == arch
    assert len(PORTED_ARCH_IDS) == 10
    with pytest.raises(KeyError):
        t_get_config("ivector-tvm")


@pytest.mark.parametrize("arch", NEW)
def test_configs_are_the_reference_s(arch):
    for smoke in (False, True):
        jc, tc = j_get_config(arch, smoke), t_get_config(arch, smoke)
        assert jc.__dict__.keys() == tc.__dict__.keys()
        for k, v in jc.__dict__.items():
            w = getattr(tc, k)
            if hasattr(v, "__dict__"):
                assert vars(v) == vars(w), k
            else:
                assert v == w, k


@pytest.mark.parametrize("arch", NEW)
def test_full_config_tables_match_jax(arch):
    """At the published widths, nothing allocated: the same parameter
    count and decode cache shapes as the JAX package."""
    jc, tc = j_get_config(arch), t_get_config(arch)
    assert tapi.n_params(tc, 1040) == japi.n_params(jc, 1040)
    jt, tt = japi.param_table(jc, 1040), tapi.param_table(tc, 1040)
    assert {k: v[0] for k, v in jt.items()} == {k: v[0]
                                                for k, v in tt.items()}
    want = {k: (tuple(s.shape), str(s.dtype)) for k, s in
            japi.cache_specs(jc, JShape("t", 1040, 4, "decode"))[0].items()}
    got = {k: (tuple(s), str(d).replace("torch.", "")) for k, (s, d) in
           tapi.cache_specs(tc, TShape("t", 1040, 4, "decode")).items()}
    assert got == want


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("H,KVH", [(4, 2), (4, 1), (4, 4)])
def test_full_attention_matches_jax(causal, H, KVH):
    """GQA, MQA and MHA; non-causal over a kv longer than the queries
    (cross-attention), causal over the same length."""
    rng = np.random.default_rng(H * KVH + causal)
    Sq, Sk = (12, 12) if causal else (7, 20)
    q = _normal(rng, 2, Sq, H, 16)
    k, v = _normal(rng, 2, Sk, KVH, 16), _normal(rng, 2, Sk, KVH, 16)
    got = TL.full_attention(_t(q), _t(k), _t(v), causal)
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, JL.full_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal))


def test_full_attention_casts_p_as_the_reference():
    """In bf16 the probabilities are rounded to bf16 before P.V, as the
    reference does (not the flash kernel's hi/lo pair): the port's output
    is JAX's on the same bf16 inputs within one bf16 ulp."""
    rng = np.random.default_rng(5)
    q, k, v = (_normal(rng, 1, 9, 2, 16) for _ in range(3))
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = TL.full_attention(tq, tk, tv, False).float()
    want = JL.full_attention(*(jnp.asarray(a, jnp.bfloat16)
                               for a in (q, k, v)), False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


def test_attention_hd256_plain_matches_pallas():
    """Gemma 2B's head dim: the port's causal attention (the plain
    version on the CPU) against the Pallas kernel in interpret mode, MQA
    (KVH 1)."""
    rng = np.random.default_rng(256)
    q = _normal(rng, 1, 64, 2, 256)
    k, v = _normal(rng, 1, 64, 1, 256), _normal(rng, 1, 64, 1, 256)
    got = tops.flash_attention(_t(q), _t(k), _t(v))
    _close(got, jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), block_q=32, block_k=32,
                                    interpret=True))


def test_whisper_encode_matches_jax():
    jc, tc, jp, tp = _model(WHISPER, 1)
    frames = _normal(np.random.default_rng(1), 2, jc.encoder.n_frames,
                     jc.encoder.frontend_dim)
    got = TWH.encode(tc, tp, _t(frames))
    assert got.shape == frames.shape[:2] + (jc.d_model,)
    _close(got, JWH.encode(jc, jp, jnp.asarray(frames)), MODEL_TOL)


def test_vlm_merge_matches_jax():
    """Patch embeddings first, then the text embeddings."""
    jc, tc, jp, tp = _model(INTERNVL, 2)
    b = _inputs(jc, 2, 5, 2)
    got = TVL._merge(tc, tp, _t(b["patches"]), _t(b["tokens"]))
    assert got.shape == (2, jc.encoder.n_frames + 5, jc.d_model)
    _close(got, JVL._merge(jc, jp, jnp.asarray(b["patches"]),
                           jnp.asarray(b["tokens"])))


def _rwkv_layer(seed):
    jc, tc = _cfgs(RWKV)
    table = {k[len("layer/"):]: v for k, v in japi.param_table(jc).items()
             if k.startswith("layer/")}
    # w0, dw2 and ts_w2 drawn too (the table's const and zero inits would
    # leave the decay and the token shift data-independent)
    table = {k: (s[1:], a, ("normal", 0.3) if k in ("dw2", "ts_w2")
                 else ("uniform", -1.5, -0.5) if k == "w0" else i)
             for k, (s, a, i) in table.items()}
    jp = JL.table_init(table, jax.random.fold_in(KEY, seed), jnp.float32)
    tp = convert.lm_params_from_numpy({k: np.asarray(v)
                                       for k, v in jp.items()}, "float32",
                                      device="cpu")
    return jc, tc, jp, tp


def _rwkv_state(jc, rng, with_state):
    B, d = 2, jc.d_model
    H, K = jc.n_heads, jc.rwkv.head_dim
    if not with_state:
        return np.zeros((B, d), np.float32), np.zeros((B, H, K, K),
                                                      np.float32)
    return _normal(rng, B, d), _normal(rng, B, H, K, K, scale=0.3)


@pytest.mark.parametrize("T,with_state", [(32, False), (32, True),
                                          (48, True), (12, True)])
def test_rwkv_time_mix_matches_jax(T, with_state):
    """Two chunks of 16 from a zero or a drawn state, three from a drawn
    state (a state carried twice), and T = 12: one
    chunk of T steps (the reference's fallback for a T that is not a
    multiple of 16, safe this short)."""
    jc, tc, jp, tp = _rwkv_layer(3)
    rng = np.random.default_rng(T + with_state)
    x = _normal(rng, 2, T, jc.d_model, scale=0.5)
    tm, wkv = _rwkv_state(jc, rng, with_state)
    got = TRK.time_mix(tc, tp, _t(x), _t(tm), _t(wkv))
    want = JRK.time_mix(jc, jp, jnp.asarray(x), jnp.asarray(tm),
                        jnp.asarray(wkv))
    for g, w in zip(got, want):
        _close(g, w)


def test_rwkv_wkv_chunk_matches_jax():
    rng = np.random.default_rng(7)
    B, c, H, K = 2, 16, 2, 8
    r, k, v = (_normal(rng, B, c, H, K) for _ in range(3))
    logw = -np.exp(_normal(rng, B, c, H, K, scale=0.5) - 1.0)
    u, st = _normal(rng, H, K), _normal(rng, B, H, K, K)
    got = TRK._wkv_chunk(*(_t(a) for a in (r, k, v, logw, u, st)))
    want = JRK._wkv_chunk(*(jnp.asarray(a) for a in (r, k, v, logw, u, st)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_time_mix_decode_matches_jax(with_state):
    jc, tc, jp, tp = _rwkv_layer(4)
    rng = np.random.default_rng(40 + with_state)
    x = _normal(rng, 2, jc.d_model, scale=0.5)
    tm, wkv = _rwkv_state(jc, rng, with_state)
    got = TRK.time_mix_decode(tc, tp, _t(x), _t(tm), _t(wkv))
    want = JRK.time_mix_decode(jc, jp, jnp.asarray(x), jnp.asarray(tm),
                               jnp.asarray(wkv))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("T", [1, 9])
def test_rwkv_channel_mix_matches_jax(T):
    jc, tc, jp, tp = _rwkv_layer(5)
    rng = np.random.default_rng(50 + T)
    x = _normal(rng, 2, T, jc.d_model, scale=0.5)
    cm = _normal(rng, 2, jc.d_model)
    got = TRK.channel_mix(tc, tp, _t(x), _t(cm))
    want = JRK.channel_mix(jc, jp, jnp.asarray(x), jnp.asarray(cm))
    for g, w in zip(got, want):
        _close(g, w)


def test_rwkv_chunked_matches_stepwise():
    """The port's chunked time mix over 48 steps (3 chunks) against its
    own single-step recurrence, output and final state (the JAX
    ``test_rwkv_chunked_matches_stepwise``, at its limit)."""
    jc, tc, _, tp = _rwkv_layer(6)
    B, T, d = 2, 48, jc.d_model
    x = _t(_normal(np.random.default_rng(6), B, T, d, scale=0.5))
    tm = torch.zeros(B, d)
    st = torch.zeros(B, jc.n_heads, jc.rwkv.head_dim, jc.rwkv.head_dim)
    out_chunk, _, st_chunk = TRK.time_mix(tc, tp, x, tm, st)
    outs = []
    for t in range(T):
        o, tm, st = TRK.time_mix_decode(tc, tp, x[:, t], tm, st)
        outs.append(o)
    _close(out_chunk, torch.stack(outs, dim=1), STEP_TOL)
    _close(st_chunk, st, STEP_TOL)


# ---------------------------------------------------------------------------
# Whole models against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_jax(arch):
    """SMOKE, f32: prefill of S - 1 tokens (plus the frames or patches),
    its logits and every cache entry; the cache padded by one position as
    the launchers pad it (an ssm's is recurrent, not padded); one decode
    step at the next position (after the patches, for a vlm), its logits
    and cache; the decode logits also agree with the full prefill's, as
    the JAX ``test_decode_matches_full_forward``."""
    jc, tc, jp, tp = _model(arch, 20)
    B, S = 2, 16
    pos = S - 1 + (jc.encoder.n_frames if jc.family == "vlm" else 0)
    jb, tb = _both(_inputs(jc, B, S, 20))
    jpre, tpre = jax.jit(japi.make_prefill_step(jc)), \
        tapi.make_prefill_step(tc)
    cut = lambda b: {k: (v[:, :-1] if k == "tokens" else v)  # noqa: E731
                     for k, v in b.items()}
    jcache, jlog = jpre(jp, cut(jb))
    tcache, tlog = tpre(tp, cut(tb))
    _close(tlog, jlog, MODEL_TOL)
    assert set(tcache) == set(jcache)
    for k in jcache:
        _close(tcache[k], jcache[k], MODEL_TOL)
    if jc.family != "ssm":
        assert tcache["k"].shape[2] == pos
        jcache = jserve.pad_cache(jcache, pos + 1)
        tcache = tserve.pad_cache(tcache, pos + 1)
    tok = jb["tokens"][:, -1]
    jcache, jlog = japi.make_decode_step(jc)(
        jp, jcache, {"token": tok, "pos": jnp.asarray(pos, jnp.int32)})
    tcache, tlog = tapi.make_decode_step(tc)(
        tp, tcache, {"token": tb["tokens"][:, -1], "pos": pos})
    _close(tlog, jlog, MODEL_TOL)
    for k in jcache:
        _close(tcache[k], jcache[k], MODEL_TOL)
    _, full = tpre(tp, tb)
    _close(tlog, full, STEP_TOL)


@pytest.mark.parametrize("arch", NEW)
def test_loss_matches_jax(arch):
    """``api.loss_fn`` (the training forward and the chunked loss) against
    JAX's; a vlm's labels cover its text positions."""
    jc, tc, jp, tp = _model(arch, 30)
    b = _inputs(jc, 2, 16, 30)
    b["labels"] = np.roll(b["tokens"], -1, axis=1)
    jb, tb = _both(b)
    want = japi.loss_fn(jc, jp, jb)
    got = tapi.loss_fn(tc, tp, tb)
    assert got.shape == () and torch.isfinite(got)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", [WHISPER, RWKV])
def test_train_step_runs_and_remat_is_bitwise(arch):
    """One train step of the new families on the CPU (the launcher leaves
    them to ``models.api``): the loss is the forward's, and recomputing
    each layer in the backward pass gives the same bits."""
    _, tc, _, tp = _model(arch, 40)
    b = _inputs(tc, 2, 16, 40)
    b["labels"] = np.roll(b["tokens"], -1, axis=1)
    tb = {k: _t(v) for k, v in b.items()}
    outs = []
    for remat in ("nothing", "layer"):
        cfg = tc.with_overrides(remat=remat)
        state = {"params": {k: v.clone() for k, v in tp.items()},
                 "opt": tapi.adamw_init(tp, tapi._opt_config(cfg, None))}
        new, metrics = tapi.make_train_step(cfg)(state, tb)
        outs.append((new, metrics))
    assert torch.isfinite(outs[0][1]["loss"])
    torch.testing.assert_close(outs[0][1]["loss"],
                               tapi.loss_fn(tc, tp, tb), rtol=0, atol=0)
    for k in tp:
        assert torch.equal(outs[0][0]["params"][k], outs[1][0]["params"][k])


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------


def test_serve_rwkv_on_cpu():
    """``serve`` at SMOKE size on the CPU for the ssm family: the
    recurrent cache is not padded, ``gen`` tokens a row, the same result
    from the same seed, the first token the prefill's argmax, and the last
    logits those of a step-by-step replay through the decode step."""
    _, tc = _cfgs(RWKV)
    runs = [tserve.serve(tc, 2, 16, 4, torch.Generator().manual_seed(3),
                         "cpu") for _ in range(2)]
    r = runs[0]
    assert r["tokens"].shape == (2, 4)
    assert torch.isfinite(r["last_logits"]).all()
    assert torch.equal(r["tokens"], runs[1]["tokens"])
    assert torch.equal(r["tokens"][:, 0],
                       torch.argmax(r["prefill_logits"], -1))
    cache, _ = tapi.make_prefill_step(tc)(r["params"],
                                          {"tokens": r["prompts"]})
    assert cache["wkv"].shape[1:] == (2, tc.n_heads, 64, 64)
    dec = tapi.make_decode_step(tc)
    for i in range(3):
        cache, logits = dec(r["params"], cache,
                            {"token": r["tokens"][:, i], "pos": 16 + i})
    assert torch.equal(logits, r["last_logits"])


@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_serve_refuses_audio_and_vlm_as_the_reference(arch):
    _, tc = _cfgs(arch)
    with pytest.raises(NotImplementedError, match="token-LM"):
        tserve.serve(tc, 2, 8, 2, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("arch", [PHI3, NEMOTRON, GEMMA, RWKV])
def test_serve_main_on_cpu(arch, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch ... --smoke --device
    cpu``: the JAX launcher's flags plus ``--device``."""
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", arch, "--smoke", "--batch", "2",
        "--prompt-len", "16", "--gen", "3", "--device", "cpu"])
    tserve.main()
    out = capsys.readouterr().out
    assert "prefill: 2x16" in out and "decode: 2 steps" in out


def test_train_launcher_refuses_the_new_families():
    """(Named while the launcher also refused ssm and moe; the name is
    kept so that its record carries on.) The launcher refuses what the
    JAX one refuses, audio, vlm and ivector, and takes the rest: ssm,
    moe, and a hybrid with experts."""
    for arch in (WHISPER, INTERNVL):
        with pytest.raises(SystemExit):
            tlaunch.check_trainable(t_get_config(arch, smoke=True))
    with pytest.raises(SystemExit):
        tlaunch.check_trainable(t_get_config(GEMMA, smoke=True)
                                .with_overrides(family="ivector"))
    for arch in (RWKV, GEMMA, "moonshot-v1-16b-a3b", "arctic-480b",
                 "jamba-v0.1-52b"):
        tlaunch.check_trainable(t_get_config(arch, smoke=True))


def test_transformer_still_refuses_experts():
    """(Named while the transformer refused experts; the name is kept so
    that its record carries on.) The transformer's table with experts is
    the reference's: an every-other layout (Jamba's) puts none in a
    decoder, whose layers stay dense; the "all" layout puts an MoE in every
    layer, beside a dense residual MLP of ``dense_residual_d_ff`` where set
    (Arctic)."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    for arch in ("jamba-v0.1-52b", "arctic-480b", "moonshot-v1-16b-a3b"):
        jc, tc = (c.with_overrides(family="dense") for c in _cfgs(arch))
        jt, tt = JT.decoder_table(jc), TT.decoder_table(tc)
        assert {k: v[0] for k, v in jt.items()} == {k: v[0]
                                                    for k, v in tt.items()}
        assert TT.is_moe_layer(tc) == (arch != "jamba-v0.1-52b")
        assert ("layer/mlp/w_up" in tt) == (arch != "moonshot-v1-16b-a3b")


# ---------------------------------------------------------------------------
# The bf16 head-dim-256 attention instances
# ---------------------------------------------------------------------------


def test_hd256_has_bf16_instances_that_fit():
    """Gemma 2B's head dim has a tensor-core forward instance and
    tensor-core backward ones (64-row blocks, the dK/dV pass split over
    the query heads), each within a block's shared memory, and the
    registry describes both."""
    bf = torch.bfloat16
    assert tfa.route(bf, 256) == "tc" and tfa.tc_width(256) == 256
    assert tfa.smem_bytes(bf, 256) <= 232448
    assert tfa.tc_rows(256) == 64 and tfa.tc_rows(128) == 128
    assert tfa.bwd_scope(bf, 256) == "tc" and tfa.bwd_rows(bf, 256) == 64
    assert tfa.bwd_smem_bytes(bf, 256) <= 232448
    cfg = {"B": 4, "S": 2048, "H": 8, "KVH": 1, "hd": 256,
           "dtype": "bfloat16"}
    inst = registry.get("flash_attention").instance(cfg)
    assert inst.grid == (2048 // 64, 8, 4)
    assert inst.smem_bytes == tfa.smem_bytes(bf, 256)
    # 32 key tiles x 4 batch rows: 2 splits reach 256 blocks; 4 x 4096
    # (Gemma's training micro-batch) needs none
    assert tfa.bwd_splits(bf, 4, 2048, 8, 1, 256) == 2
    assert tfa.bwd_splits(bf, 4, 4096, 8, 1, 256) == 1
    assert tfa.bwd_splits(bf, 1, 4096, 8, 1, 256) == 4
    assert tfa.bwd_splits(bf, 1, 80, 8, 1, 256) == 8
    assert tfa.bwd_splits(bf, 1, 4096, 8, 1, 128) == 1
    # f32 (the CUDA cores) splits its dK/dV pass by the same rule: 64 key
    # tiles of 64 rows at B = 1 need 4, Gemma's 4 x 4096 none
    assert tfa.bwd_splits(torch.float32, 1, 4096, 8, 1, 256) == 4
    assert tfa.bwd_splits(torch.float32, 4, 4096, 8, 1, 256) == 1
    inst = registry.get("flash_attention_bwd").instance(cfg)
    assert (inst.scope, inst.threads) == ("tc", 384)
    assert inst.grid == (2048 // 64, 2, 4)
    assert inst.smem_bytes == tfa.bwd_smem_bytes(bf, 256)


def test_bf16_dims_outside_the_instances_still_raise():
    q = torch.zeros(1, 8, 2, 520, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 520, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 1 to 512, not 520"):
        tfa.flash_attention(q, k, k)
    q = torch.zeros(1, 8, 2, 256, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd(q, k, k, q, torch.zeros(1, 2, 8), q)
