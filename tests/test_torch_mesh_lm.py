"""The LM side's mesh paths of the port against the JAX package, on one
spawned world of 4 gloo ranks on the CPU (``launch.mesh.run_ranks``; the
rank function is ``tests/_torch_mesh_lm_ranks.lm_world``, which imports
no JAX) and, in process, one lowering in a fake world of 8.

- ``layers.ring_attention`` on (1, 4), H 6 and KVH 2, against the JAX
  ``blockwise_causal_attention`` to 2e-4, its kv rotations counted;
- ``moe.moe_a2a`` with ``sp`` True and False on (2, 2), against the JAX
  ``moe_dense`` of a Moonlight SMOKE layer at capacity factor 64 (no
  token dropped) to 2e-4; its aux loss is the mean over the ranks of
  each rank's block's, as the reference's ``pmean``; its gradients
  against ``jax.grad`` of the same;
- a Phi-3 SMOKE train step on (2, 2) against the JAX one-device step:
  loss and grad norm to rtol 1e-4, every param to 3e-3, every gradient
  leaf against ``jax.grad``, and the same step repeated on the mesh
  bitwise;
- elastic restore: a state saved on (4, 1) with its logical axes comes
  back on (2, 2) as each rank's exact block, bitwise, and whole on one
  rank; a checkpoint the JAX package saved with ``logical_axes``
  restores onto the same (2, 2) blocks;
- an Arctic SMOKE train step lowered in a ``fake_world`` of 8 on
  (2, 2, 2): flops, bytes and collective bytes > 0, as
  ``tests/test_distributed.py::test_mini_dryrun_multipod_compiles``
  asserts of the reference.
"""
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as JCM  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import MoEConfig as JMoE  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch.checkpoint import manager as TCM  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.base import get_config as t_get_config  # noqa: E402
from repro_torch.launch import dryrun as TDRY  # noqa: E402
from repro_torch.launch import mesh as MS  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_mesh_lm_ranks as RK  # noqa: E402

# the world's own limit: its ranks share this machine with the other
# test workers
DEADLINE = 180
TOL = 2e-4
# a sharded gradient against JAX's, as a share of the leaf's largest entry
GRAD_RTOL = 1e-4

# one LM cell's dry-run row on each production mesh, as the CPU lowers it
# (torch 2.13): chip_smoke.py phase 14 holds the card's rows (torch 2.11)
# to these, every key (read with ast)
LM_PINS = {
    "stablelm-1.6b__train_4k__single": {
        "flops_per_device": 52295521796096.0,
        "kernels": {"flash_attention": 48, "flash_attention_bwd": 24},
        "coll_bytes_per_device": 36158996624.0,
        "collectives": {"all-reduce": 593002640.0,
                        "all-gather": 2520121344.0,
                        "reduce-scatter": 33045872640.0}},
    "stablelm-1.6b__train_4k__multi": {
        "flops_per_device": 26147760898048.0,
        "kernels": {"flash_attention": 48, "flash_attention_bwd": 24},
        "coll_bytes_per_device": 18546737304.0,
        "collectives": {"all-reduce": 445825176.0,
                        "all-gather": 1295384576.0,
                        "reduce-scatter": 16805527552.0}},
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(prefix, tree):
    return {prefix + k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Writes the inputs, spawns the world, and computes the JAX
    references while it runs."""
    wd = tmp_path_factory.mktemp("mesh_lm")
    rng = np.random.default_rng(0)
    z = {}
    for n, h in (("q", 6), ("k", 2), ("v", 2), ("do", 6)):
        z["ring/" + n] = rng.standard_normal((2, 32, h, 16)).astype(
            np.float32)
    jmoe = j_get_config("moonshot-v1-16b-a3b", smoke=True).with_overrides(
        moe=JMoE(n_experts=8, top_k=2, d_ff_expert=128, capacity_factor=64.0,
                 layout="all"))
    mp = _np(japi.init_params(jmoe, jax.random.PRNGKey(1)))
    for n in ("router", "w_up", "w_down", "w_gate"):
        z["moe/" + n] = mp["layer/moe/" + n][0]
    z["moe/x"] = rng.standard_normal((4, 16, jmoe.d_model)).astype(
        np.float32)
    z["moe/dy"] = rng.standard_normal(z["moe/x"].shape).astype(np.float32)
    jstep_cfg = j_get_config("phi3-medium-14b", smoke=True)
    state = _np(japi.init_state(jstep_cfg, jax.random.PRNGKey(2)))
    z.update(_flat("p/", state["params"]))
    z.update(_flat("m/", state["opt"]["m"]))
    z.update(_flat("v/", state["opt"]["v"]))
    z["count"] = np.asarray(state["opt"]["count"])
    toks = rng.integers(0, jstep_cfg.vocab_size, (4, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    z["batch/tokens"], z["batch/labels"] = batch["tokens"], batch["labels"]
    jck = str(wd / "jax_ckpt")
    JCM.save(jck, 1, {"params": state["params"]},
             logical_axes={"params": japi.params_axes(jstep_cfg)})
    z["jax_ckpt"] = np.array(jck)
    path = str(wd / "inputs.npz")
    np.savez(path, **z)
    t0 = time.monotonic()
    try:
        ranks = MS.run_ranks(RK.lm_world, 4, args=(path, str(wd)),
                             device="cpu", timeout=DEADLINE, threads=1)
    except Exception as e:
        progress = {f: (wd / f).read_text() for f in os.listdir(wd)
                    if f.startswith("progress_")}
        raise RuntimeError(f"the world failed after "
                           f"{time.monotonic() - t0:.0f} s; phases: "
                           f"{progress}") from e
    # JAX references
    o, vjp = jax.vjp(JL.blockwise_causal_attention,
                     *(jnp.asarray(z["ring/" + n]) for n in "qkv"))
    ref = {"ring": np.asarray(o)}
    for n, g in zip("qkv", vjp(jnp.asarray(z["ring/do"]))):
        ref["ring_d" + n] = np.asarray(g)
    jp = {n: jnp.asarray(z["moe/" + n]) for n in ("router", "w_up",
                                                   "w_down", "w_gate")}
    y, _ = JMOE.moe_dense(jmoe, jp, jnp.asarray(z["moe/x"]))
    ref["moe"] = np.asarray(y)

    def a2a_aux(x, p):
        """The a2a's aux loss: every rank's block's (data rows x model
        seq block), averaged."""
        return jnp.mean(jnp.stack([JMOE._route(jmoe, p, x[
            2 * i:2 * i + 2, 8 * j:8 * j + 8].reshape(-1, x.shape[-1]))[2]
            for i in range(2) for j in range(2)]))

    x = jnp.asarray(z["moe/x"])
    ref["moe_aux"] = np.float32(a2a_aux(x, jp))

    def moe_obj(x, p):
        return (jnp.sum(JMOE.moe_dense(jmoe, p, x)[0]
                        * jnp.asarray(z["moe/dy"]))
                + RK.MOE_AUX_COEF * a2a_aux(x, p))

    gx, gp = jax.grad(moe_obj, argnums=(0, 1))(x, jp)
    ref["moe_dx"] = np.asarray(gx)
    for n, g in gp.items():
        ref["moe_d" + n] = np.asarray(g)
    jstate = jax.tree.map(jnp.asarray, state)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    js, jm = jax.jit(japi.make_train_step(jstep_cfg))(jstate, jbatch)
    ref["loss"] = float(jm["loss"])
    ref["grad_norm"] = float(jm["grad_norm"])
    ref["params"] = _np(js["params"])
    ref["grads"] = _np(jax.jit(jax.grad(
        lambda p, b: japi.loss_fn(jstep_cfg, p, b)))(jstate["params"],
                                                     jbatch))
    ref["init"] = state["params"]
    return ranks, ref


def test_ring_attention_matches_jax(world):
    """The output and, through the reverse permutes, q's, k's and v's
    gradients."""
    ranks, ref = world
    for out in ranks:
        np.testing.assert_allclose(out["ring"], ref["ring"], atol=TOL,
                                   rtol=0)
        for n in "qkv":
            np.testing.assert_allclose(out["ring_d" + n], ref["ring_d" + n],
                                       atol=TOL, rtol=0)
    # two kv rotations (k and v) a step, three steps on a ring of 4, and
    # as many reverse ones in the backward
    calls, nbytes = ranks[0]["ring_by_op"]
    assert calls == 12 and nbytes == 12 * 2 * 8 * 2 * 16 * 4


@pytest.mark.parametrize("sp", [True, False])
def test_moe_a2a_matches_jax_moe_dense(world, sp):
    ranks, ref = world
    for out in ranks:
        np.testing.assert_allclose(out[f"moe_sp{int(sp)}"], ref["moe"],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(out[f"moe_aux_sp{int(sp)}"],
                                   ref["moe_aux"], rtol=1e-5)


@pytest.mark.parametrize("sp", [True, False])
def test_moe_a2a_gradients_match_jax(world, sp):
    """The gradients of sum(y dy) + c aux with respect to x, the router
    and the three expert tables, against ``jax.grad`` of the JAX
    ``moe_dense`` (and the per-block aux): each to GRAD_RTOL of its own
    largest entry. A rank's router and expert-table gradients are
    partial sums over the tokens it holds, and sp=False gives each model
    rank x's gradient on its own block of the sequence only, so a
    gradient left unreduced over any axis lands far outside it."""
    ranks, ref = world
    for out in ranks:
        for n in ("x", "router", "w_up", "w_down", "w_gate"):
            want = ref["moe_d" + n]
            got = out[f"moe_sp{int(sp)}_d{n}"]
            assert got.shape == want.shape, n
            np.testing.assert_allclose(
                got, want, atol=GRAD_RTOL * np.abs(want).max(), rtol=0,
                err_msg=n)


def test_sharded_train_step_matches_jax(world):
    ranks, ref = world
    for out in ranks:
        assert abs(float(out["step0/loss"]) - ref["loss"]) <= \
            1e-4 * abs(ref["loss"])
        assert abs(float(out["step0/grad_norm"]) - ref["grad_norm"]) <= \
            1e-4 * ref["grad_norm"]
        for k, want in ref["params"].items():
            got = out["step0/p/" + k]
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 3e-3, k
    # the counter saw DTensor's collectives: the fsdp gathers, the
    # reduce-scatters into the sequence-parallel residual, the reductions
    coll = ranks[0]["step0/coll"]
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(coll)
    assert all(v > 0 for v in coll.values())
    assert coll == ranks[0]["step1/coll"]


def test_sharded_train_step_gradients_match_jax(world):
    """The gradients the sharded step feeds the optimizer, every leaf to
    GRAD_RTOL of its own largest entry against ``jax.grad`` of the JAX
    loss. (The params after one step cannot show them: the warm-up's
    first rate, 3e-6, moves a param by about that much whatever the
    gradient.)"""
    ranks, ref = world
    for out in ranks:
        for k, want in ref["grads"].items():
            got = out["grad/" + k]
            assert got.shape == want.shape, k
            np.testing.assert_allclose(
                got, want, atol=GRAD_RTOL * np.abs(want).max(), rtol=0,
                err_msg=k)


def test_sharded_train_step_repeats_bitwise(world):
    ranks, _ = world
    for out in ranks:
        assert out["step0/loss"] == out["step1/loss"]
        assert out["step0/grad_norm"] == out["step1/grad_norm"]
        for k in [n for n in out if n.startswith("step0/p/")]:
            np.testing.assert_array_equal(out[k],
                                          out["step1/" + k[len("step0/"):]])


@pytest.mark.parametrize("source", ["elastic", "elastic_jax"])
def test_elastic_restore_gives_each_rank_its_block(world, source):
    """Saved whole (by the port on (4, 1), or by the JAX package), the
    state comes back on (2, 2) as each rank's block, bitwise."""
    ranks, ref = world
    for out in ranks:
        for k, whole in ref["init"].items():
            off = out[f"{source}_off/{k}"]
            loc = out[f"{source}/{k}"]
            want = np.asarray(whole, np.float32)[tuple(
                slice(o, o + n) for o, n in zip(off, loc.shape))]
            np.testing.assert_array_equal(loc, want)
    # the embedding table is split over 'vocab' -> model, and replicated
    # over data
    assert str(ranks[0][f"{source}_pl/embed"]) == \
        "(Replicate(), Shard(dim=0))"


def test_elastic_restore_on_one_rank(world):
    """The same checkpoint without rules: the whole arrays."""
    ranks, ref = world
    cfg = t_get_config("phi3-medium-14b", smoke=True)
    like = {"params": dict.fromkeys(tapi.params_axes(cfg))}
    got, step, _ = TCM.restore(str(ranks[0]["elastic_dir"]), like,
                               device="cpu")
    assert step == 1
    for k, whole in ref["init"].items():
        np.testing.assert_array_equal(got["params"][k].numpy(),
                                      np.asarray(whole, np.float32))


def test_arctic_train_step_lowers_in_a_fake_world():
    cfg = t_get_config("arctic-480b", smoke=True)
    shape = ShapeConfig("train", 64, 8, "train")
    with MS.fake_world(8):
        mesh = MS.make_local_mesh(2, 2, 2)
        counter, rules, held = TDRY.lower_lm(cfg, shape, mesh)
    assert counter.flops > 0 and counter.bytes > 0, counter.by_op
    assert counter.coll_bytes > 0, mesh.by_op
    assert held > 0 and counter.peak_bytes > 0
    # the experts' exchange and the ring-free attention ran their paths
    assert mesh.by_op["all-to-all"][0] > 0
    assert counter.kernels["flash_attention"][0] > 0


@pytest.mark.parametrize("key", sorted(LM_PINS))
def test_lm_dryrun_rows_are_pinned(key):
    """The production rows of one LM cell: rank 0's share of a StableLM-2
    1.6B train step at train_4k on meta tensors in a fake world of 256
    and 512 ranks."""
    arch, shape, tag = key.split("__")
    _, row = TDRY.lower_cell(arch, shape, tag == "multi")
    assert row["status"] == "ok" and row["fallbacks"] == []
    assert {k: row[k] for k in LM_PINS[key]} == LM_PINS[key]
