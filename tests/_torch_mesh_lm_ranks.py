"""Rank function of ``tests/test_torch_mesh_lm.py``: it runs in each
process of a world of 4 that ``repro_torch.launch.mesh.run_ranks``
spawns, on the CPU over gloo, and returns numpy arrays. It imports
neither JAX nor the JAX package; the inputs come from an npz file the
test writes (JAX draws and JAX outputs stay in the test process).

One world holds every check, each on its own mesh of the same 4 ranks:
ring attention on (1, 4), ``moe_a2a`` (sp on and off, forward and
gradients) and a Phi-3 SMOKE train step, twice, and its gradients, on
(2, 2), and the elastic checkpoint: saved on (4, 1), restored on (2, 2).
"""
import os
import time

import numpy as np
import torch
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch import convert
from repro_torch.analysis.op_cost import OpCounter
from repro_torch.checkpoint import manager as CM
from repro_torch.configs.base import MoEConfig, get_config
from repro_torch.launch import mesh as MS
from repro_torch.models import api, layers as L, moe as MOE
from repro_torch.sharding import make_rules, use_rules

_IMPORTED = time.monotonic()

MOE_CFG = get_config("moonshot-v1-16b-a3b", smoke=True).with_overrides(
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=128, capacity_factor=64.0,
                  layout="all"))
STEP_CFG = get_config("phi3-medium-14b", smoke=True)
MOE_LEAVES = ("router", "w_up", "w_down", "w_gate")
# the aux loss's weight in the gradient check of moe_a2a
MOE_AUX_COEF = 0.5


def mark(workdir, what: str) -> None:
    """Append ``what`` and the seconds since import to this rank's progress
    file in ``workdir`` (what a timed-out world's error quotes)."""
    with open(os.path.join(workdir, f"progress_{os.getpid()}.txt"),
              "a") as fh:
        fh.write(f"{what} {time.monotonic() - _IMPORTED:.1f}s\n")


def _full(t):
    return t.full_tensor().detach().cpu().numpy()


def _tree(z, prefix):
    n = len(prefix)
    return {k[n:]: z[k] for k in z.files if k.startswith(prefix)}


def _state(z, device="cpu"):
    return convert.lm_state_from_numpy(
        {"params": _tree(z, "p/"),
         "opt": {"m": _tree(z, "m/"), "v": _tree(z, "v/"),
                 "count": z["count"]}}, "float32", device)


def _step(rules, z):
    cfg = STEP_CFG
    axes = api.state_axes(cfg)
    host = _state(z, rules.mesh.device)
    st = {"params": api.distribute(host["params"], axes["params"], rules),
          "opt": {"m": api.distribute(host["opt"]["m"], axes["opt"]["m"],
                                      rules),
                  "v": api.distribute(host["opt"]["v"], axes["opt"]["v"],
                                      rules),
                  "count": host["opt"]["count"]}}
    batch = {k: torch.as_tensor(z["batch/" + k], device=rules.mesh.device)
             for k in ("tokens", "labels")}
    step = api.make_train_step(cfg)
    with use_rules(rules):
        b = api.distribute(batch, api.input_axes(
            cfg, _shape(batch["tokens"].shape, "train")))
        with OpCounter(rules.mesh) as counter:
            new, met = step(st, b)
    return new, met, counter.coll


def _grads(rules, z):
    """The gradients the train step of ``_step`` feeds the optimizer."""
    cfg = STEP_CFG
    params = api.distribute(_state(z, rules.mesh.device)["params"],
                            api.params_axes(cfg), rules)
    batch = {k: torch.as_tensor(z["batch/" + k], device=rules.mesh.device)
             for k in ("tokens", "labels")}
    with use_rules(rules):
        b = api.distribute(batch, api.input_axes(
            cfg, _shape(batch["tokens"].shape, "train")))
        with api.on_mesh(params):
            return api.loss_and_grads(cfg, params, b)[1]


def _shape(bs, kind):
    from repro_torch.configs.base import ShapeConfig
    return ShapeConfig("t", bs[1], bs[0], kind)


def lm_world(path, workdir, device="cpu"):
    """Every check of the world, its ranks on ``device``; returns {name:
    numpy array}."""
    z = np.load(path)
    out = {}
    rank = torch.distributed.get_rank()

    # ring attention on (1, 4): H 6, KVH 2
    mark(workdir, "ring")
    mesh = MS.make_local_mesh(1, 4, device=device)
    rules = make_rules(mesh)
    q, k, v, do = (torch.as_tensor(z["ring/" + n], device=device)
                   for n in ("q", "k", "v", "do"))
    with use_rules(rules):
        ax = ("batch", None, None, None)
        qkv = [rules.distribute(t, ax).requires_grad_(True)
               for t in (q, k, v)]
        o = L.ring_attention(*qkv)
        grads = torch.autograd.grad(o, qkv, rules.distribute(do, ax))
        out["ring"] = _full(o)
        for n, g in zip("qkv", grads):
            out["ring_d" + n] = _full(g)
    out["ring_by_op"] = np.array(mesh.by_op["collective-permute"])

    # moe_a2a on (2, 2), sp on and off: y, the aux loss, and the
    # gradients of sum(y dy) + MOE_AUX_COEF aux
    mesh = MS.make_local_mesh(2, 2, device=device)
    for sp in (True, False):
        mark(workdir, f"moe sp={sp}")
        rules = make_rules(mesh, MOE_CFG, _shape(z["moe/x"].shape, "train"))
        p = {n: torch.as_tensor(z["moe/" + n], device=device)
             for n in MOE_LEAVES}
        xax = ("batch", "seq_sp" if sp else "seq", None)
        with use_rules(rules):
            x = rules.distribute(torch.as_tensor(z["moe/x"], device=device),
                                 xax)
            pp = {"router": rules.distribute(p["router"], ("dmodel", None))}
            for n in ("w_up", "w_gate"):
                pp[n] = rules.distribute(p[n], ("experts", "fsdp", None))
            pp["w_down"] = rules.distribute(p["w_down"],
                                            ("experts", None, "fsdp"))
            leaves = [x.requires_grad_(True)] + [
                pp[n].requires_grad_(True) for n in MOE_LEAVES]
            y, aux = MOE.moe_a2a(MOE_CFG, pp, x, sp)
            dy = rules.distribute(torch.as_tensor(z["moe/dy"],
                                                  device=device), xax)
            grads = torch.autograd.grad(
                [y, aux], leaves, [dy, torch.full_like(aux, MOE_AUX_COEF)])
            out[f"moe_sp{int(sp)}"] = _full(y)
            out[f"moe_aux_sp{int(sp)}"] = _full(aux)
            for n, g in zip(("x",) + MOE_LEAVES, grads):
                out[f"moe_sp{int(sp)}_d{n}"] = _full(g)

    # a Phi-3 SMOKE train step on (2, 2), twice from the same state
    rules = make_rules(mesh, STEP_CFG, _shape(z["batch/tokens"].shape,
                                              "train"))
    for rep in range(2):
        mark(workdir, f"step {rep}")
        new, met, coll = _step(rules, z)
        out[f"step{rep}/coll"] = coll
        out[f"step{rep}/loss"] = met["loss"].cpu().numpy()
        out[f"step{rep}/grad_norm"] = met["grad_norm"].cpu().numpy()
        for n, t in new["params"].items():
            out[f"step{rep}/p/{n}"] = _full(t)
    # the same step's gradients, each leaf whole
    mark(workdir, "grads")
    for n, g in _grads(rules, z).items():
        out[f"grad/{n}"] = _full(g)

    # elastic checkpoint: saved on (4, 1), restored on (2, 2)
    mark(workdir, "elastic")
    ck = os.path.join(workdir, "elastic")
    m41 = MS.make_local_mesh(4, 1, device=device)
    r41 = make_rules(m41, STEP_CFG)
    axes = api.params_axes(STEP_CFG)
    params = api.distribute(_state(z, device)["params"], axes, r41)
    CM.CheckpointManager(ck, logical_axes={"params": axes},
                         mesh=m41).maybe_save(1, {"params": params},
                                              force=True)
    m22 = MS.make_local_mesh(2, 2, device=device)
    r22 = make_rules(m22, STEP_CFG)
    like = {"params": dict.fromkeys(axes)}
    for tag_, d in (("elastic", ck), ("elastic_jax", str(z["jax_ckpt"]))):
        got, _, _ = CM.restore(d, like, step=1, rules=r22)
        for n, t in got["params"].items():
            out[f"{tag_}/{n}"] = t.to_local().cpu().numpy()
            out[f"{tag_}_off/{n}"] = np.array(
                compute_local_shape_and_global_offset(
                    t.shape, t.device_mesh, t.placements)[1])
            out[f"{tag_}_pl/{n}"] = np.array(str(tuple(t.placements)))
    out["elastic_dir"] = np.array(ck)
    mark(workdir, f"done rank {rank}")
    return out
