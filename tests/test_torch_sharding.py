"""The port's logical-axis sharding (``repro_torch/sharding``), the model
API's axes functions, ``dryrun.model_flops_estimate`` and gradient
compression (``repro_torch/distributed/compression.py``) against the JAX
package, in process, with no ranks spawned.

- Rules: ``make_rules(...).table``, the spec of every param, cache entry
  and input, and the fallbacks they record equal the JAX ``make_rules``'
  on ``jax.sharding.AbstractMesh`` meshes of (16, 16) and (2, 16, 16),
  for every LM arch x shape; the reference's attention block size and
  ``use_ring_attention`` under those rules too.
- ``params_axes``, ``state_axes``, ``input_specs``, ``input_axes`` and the
  cache axes equal the JAX ones name for name.
- ``model_flops_estimate`` equals the JAX one exactly.
- The int8 and top-k codecs equal the JAX ones bitwise on seeded numpy
  inputs, and ``tests/test_substrate.py``'s two properties hold for the
  port (error feedback converges; int8 error <= 0.51 x scale).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.distributed import compression as JCOMP  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.sharding import make_rules as j_make_rules  # noqa: E402
from repro.sharding import use_rules as j_use_rules  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.distributed import compression as TCOMP  # noqa: E402
from repro_torch.launch import dryrun as TDRY  # noqa: E402
from repro_torch.launch import mesh as MS  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.sharding import make_rules as t_make_rules  # noqa: E402
from repro_torch.sharding import use_rules as t_use_rules  # noqa: E402

# the JAX dry-run module sets XLA_FLAGS (512 host devices) when imported;
# put the variable back, so no later JAX start in this process sees it
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JDRY  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

LM_ARCHS = TC.PORTED_ARCH_IDS
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SHAPES = [s.name for s in TC.ALL_SHAPES]


def _meshes(name):
    sizes, axes = MESHES[name]
    return (AbstractMesh(sizes, axes),
            MS.Mesh(axes, sizes, (0,) * len(sizes), torch.device("meta")))


def _struct_shapes(tree):
    """{name: shape} of a JAX ShapeDtypeStruct dict."""
    return {k: tuple(v.shape) for k, v in tree.items()}


def _cells(jc, shape):
    """[(name, shape, axes)] of every param, cache entry and input of a
    cell, in one order for both packages."""
    max_seq = shape.seq_len if jc.family == "audio" else 0
    p_shapes = _struct_shapes(japi.params_struct(jc, max_seq))
    p_axes = japi.params_axes(jc, max_seq)
    c_struct, c_axes = japi.cache_specs(jc, shape)
    i_shapes = _struct_shapes(japi.input_specs(jc, shape))
    i_axes = japi.input_axes(jc, shape)
    out = [("p/" + k, p_shapes[k], p_axes[k]) for k in sorted(p_shapes)]
    out += [("c/" + k, tuple(c_struct[k].shape), c_axes[k])
            for k in sorted(c_struct)]
    out += [("i/" + k, i_shapes[k], i_axes[k]) for k in sorted(i_shapes)]
    return out


def _attn_block_size(rules, B, S, H):
    """The reference's score-block size (``repro/models/layers.py``), one
    [B_loc, qb, H_loc, kb] f32 block under ~256 MB a device, computed from
    the port's rules table. The port's flash kernel picks its own blocks,
    so this only checks that the table gives the reference's local
    extents."""
    d_size = rules.axis_size(rules.table.get("batch"))
    m_size = rules.axis_size(rules.table.get("heads"))
    b_sh = d_size if B % max(d_size, 1) == 0 else 1
    h_sh = m_size if H % max(m_size, 1) == 0 else 1
    per_row = max((B // b_sh) * (H // h_sh), 1)
    blk = 2048
    while blk > 128 and blk * blk * per_row > 256e6 / 4.0:
        blk //= 2
    while S % blk != 0 and blk > 1:
        blk //= 2
    return max(blk, 1)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_rules_specs_and_fallbacks_match_jax(arch, shape, mesh):
    jmesh, tmesh = _meshes(mesh)
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    jshape, tshape = JC.get_shape(shape), TC.get_shape(shape)
    jr, tr = j_make_rules(jmesh, jc, jshape), t_make_rules(tmesh, tc, tshape)
    assert tr.table == jr.table
    for name, s, axes in _cells(jc, jshape):
        want = tuple(jr.spec(len(s), axes, s))
        assert tr.spec(len(s), axes, s) == want, name
    assert tr.fallbacks == jr.fallbacks
    # the reference's attention block size read off the port's rules,
    # and the ring choice, read the same rules
    B, S = jshape.global_batch, jshape.seq_len
    H, hd = jc.n_heads, jc.resolved_head_dim()
    with j_use_rules(jr), t_use_rules(tr):
        assert _attn_block_size(tr, B, S, H) == \
            JL._attn_block_size(B, S, H, hd)
        assert TL.use_ring_attention(tc, B, S) == \
            JL.use_ring_attention(jc, B, S)


def test_rules_without_a_config_and_placements():
    """Rules on a bare mesh (the ivector cell's), and the DTensor
    placements a spec gives: a dim over (pod, data) nests in mesh order,
    an axis of extent 1 is no dimension of the DeviceMesh."""
    jmesh, tmesh = _meshes("2x16x16")
    assert t_make_rules(tmesh).table == j_make_rules(jmesh).table
    from torch.distributed.tensor import Replicate, Shard
    r = t_make_rules(tmesh)
    assert r.dm_axes == ("pod", "data", "model")
    assert r.placements((64, 8, 32), ("batch", None, "heads")) == (
        Shard(0), Shard(0), Shard(2))
    assert r.placements((64, 8, 30), ("batch", None, "heads")) == (
        Shard(0), Shard(0), Replicate())
    assert r.fallbacks == [("heads", (64, 8, 30), 2)]
    one = t_make_rules(MS.Mesh(("data", "model"), (4, 1), (0, 0),
                               torch.device("meta")))
    assert one.dm_axes == ("data",)
    assert one.placements((8, 4), ("batch", "heads")) == (Shard(0),)
    with pytest.raises(ValueError, match="mesh order"):
        r.placements_of((("data", "pod"), None))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_axes_functions_match_jax(arch):
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    max_seq = 4096 if jc.family == "audio" else 0
    assert tapi.params_axes(tc, max_seq) == japi.params_axes(jc, max_seq)
    assert tapi.state_axes(tc, max_seq) == japi.state_axes(jc, max_seq)
    for s in TC.ALL_SHAPES:
        js = JC.get_shape(s.name)
        assert tapi.input_axes(tc, s) == japi.input_axes(jc, js)
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in japi.input_specs(jc, js).items()}
        got = {k: (tuple(shp), str(dt).removeprefix("torch."))
               for k, (shp, dt) in tapi.input_specs(tc, s).items()}
        assert got == want
        j_struct, j_axes = japi.cache_specs(jc, js)
        assert tapi.cache_axes(tc) == j_axes
        assert {k: tuple(v[0]) for k, v in tapi.cache_specs(tc, s).items()} \
            == {k: tuple(v.shape) for k, v in j_struct.items()}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_flops_estimate_is_exact(arch):
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    for s in TC.ALL_SHAPES:
        assert TDRY.model_flops_estimate(tc, s) == \
            JDRY.model_flops_estimate(jc, JC.get_shape(s.name)), s.name


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,chunk", [((1024,), 128), ((37, 11), 256),
                                         ((3, 5, 64), 64), ((1,), 256)])
def test_int8_codec_bitwise_jax(shape, chunk):
    g = np.random.default_rng(3).standard_normal(shape).astype(np.float32) * 3
    want = np.asarray(JCOMP._int8_codec(jnp.asarray(g), chunk=chunk))
    got = TCOMP._int8_codec(torch.as_tensor(g), chunk=chunk).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,frac", [((1024,), 0.05), ((37, 11), 0.1),
                                        ((7,), 0.5), ((64, 3), 0.001)])
def test_topk_codec_bitwise_jax(shape, frac):
    g = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = np.asarray(JCOMP._topk_codec(jnp.asarray(g), frac=frac))
    got = TCOMP._topk_codec(torch.as_tensor(g), frac=frac).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_compress_with_feedback_bitwise_jax(codec):
    rng = np.random.default_rng(5)
    grads = {"a": rng.standard_normal((40, 7)).astype(np.float32),
             "b": rng.standard_normal((300,)).astype(np.float32)}
    jerr = JCOMP.init_error_feedback({k: jnp.asarray(v)
                                      for k, v in grads.items()})
    terr = TCOMP.init_error_feedback({k: torch.as_tensor(v)
                                      for k, v in grads.items()})
    for step in range(3):
        g = {k: v * (step + 1) for k, v in grads.items()}
        js, jerr = JCOMP.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jerr, codec,
            frac=0.1, chunk=64)
        ts, terr = TCOMP.compress_with_feedback(
            {k: torch.as_tensor(v) for k, v in g.items()}, terr, codec,
            frac=0.1, chunk=64)
        for k in g:
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))
    for c in ("int8", "topk", "none"):
        assert TCOMP.compression_ratio(c, 0.05) == \
            JCOMP.compression_ratio(c, 0.05)


def test_compression_error_feedback_convergence():
    """The port of tests/test_substrate.py's property: EF-compressed SGD
    reaches a loss comparable to exact SGD on a least-squares problem;
    without EF, top-k stalls measurably."""
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.standard_normal((256, 32)).astype(np.float32))
    y = X @ torch.as_tensor(rng.standard_normal(32).astype(np.float32))

    def loss(w):
        return torch.mean((X @ w - y) ** 2)

    def grad(w):
        return 2.0 * X.T @ (X @ w - y) / X.shape[0]

    def run(codec, use_ef, steps=150, lr=0.02):
        w = torch.zeros(32)
        err = {"w": torch.zeros(32)}
        for _ in range(steps):
            g = {"w": grad(w)}
            if codec:
                if use_ef:
                    g, err = TCOMP.compress_with_feedback(g, err, codec,
                                                          frac=0.1)
                else:
                    g = {"w": TCOMP._topk_codec(g["w"], 0.1)}
            w = w - lr * g["w"]
        return float(loss(w))

    exact = run(None, False)
    ef = run("topk", True)
    no_ef = run("topk", False)
    assert ef < 10 * max(exact, 1e-6) + 1e-3
    assert ef <= no_ef + 1e-6
    assert run("int8", True) < 10 * max(exact, 1e-6) + 1e-3


def test_int8_codec_bounded_error():
    g = torch.as_tensor(np.random.default_rng(0).standard_normal(
        1024).astype(np.float32)) * 3
    deq = TCOMP._int8_codec(g, chunk=128)
    scale = g.abs().reshape(-1, 128).amax(1).numpy() / 127
    err = (deq - g).abs().reshape(-1, 128).numpy()
    assert (err <= scale[:, None] * 0.51 + 1e-7).all()


def test_check_fits_counts_a_ranks_shards():
    """``launch.train.check_fits`` under rules counts one rank's shards:
    Arctic's state, past one card whole (the exit names how many cards it
    needs), fits a rank of the 2 x 16 x 16 production mesh."""
    import math
    from repro_torch.launch import train as TLAUNCH
    cfg = TC.get_config("arctic-480b")
    _, tmesh = _meshes("2x16x16")
    rules = t_make_rules(tmesh, cfg, TC.get_shape("train_4k"))
    cap = 80 * 10**9
    whole = TLAUNCH.state_bytes(cfg, 0)
    per_rank = TLAUNCH.state_bytes(cfg, 0, rules)
    assert per_rank < cap < whole
    # 512 ranks; leaves whose dims do not divide (the kv heads, the
    # router) stay whole on more of them
    assert 128 < whole / per_rank < 512
    TLAUNCH.check_fits(cfg, 0, cap, rules)
    with pytest.raises(SystemExit,
                       match=f"at least {math.ceil(whole / cap)} cards"):
        TLAUNCH.check_fits(cfg, 0, cap)
