"""Rank functions of ``tests/test_torch_mesh.py``: each runs in a process
that ``repro_torch.launch.mesh.run_ranks`` spawns, on the CPU over gloo,
and returns numpy arrays. They import neither JAX nor the JAX package, so
that a spawned rank starts quickly; the inputs come from an npz file the
test writes.
"""
import os
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.api import artifacts as AR
from repro_torch.configs.ivector_tvm import SMOKE
from repro_torch.core import engine as EN
from repro_torch.core import trainer as TR
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U
from repro_torch.launch import ivector_cell as IC
from repro_torch.launch import mesh as MS

# the JAX tests' sizes (tests/test_mesh_trainer.py): D 8, C 16, R 12, K 8
CFG = SMOKE.with_overrides(feat_dim=8, n_components=16, ivector_dim=12,
                           posterior_top_k=8, lda_dim=8, n_iters=3,
                           realign_interval=2, ubm_update="full",
                           update_sigma=True)
# per-utterance statistics are compared at one chunk size on every mesh
NF_CHUNK = 12
SEED = 100


# when this module was imported in the rank (before its rendezvous)
_IMPORTED = time.monotonic()


def mark(path, world: str, what: str) -> None:
    """Append ``what`` and the seconds since this module's import to the
    progress file of ``world`` and this rank's process, beside ``path``:
    the phases a timed-out world had reached (``progress``)."""
    f = os.path.join(os.path.dirname(path),
                     f"progress_{world}_{os.getpid()}.txt")
    with open(f, "a") as fh:
        fh.write(f"{what} {time.monotonic() - _IMPORTED:.1f}s\n")


def progress(workdir, world: str) -> dict:
    """{pid: the phases its rank of ``world`` reached, with their
    seconds}."""
    out = {}
    for name in sorted(os.listdir(workdir)):
        if name.startswith(f"progress_{world}_"):
            with open(os.path.join(workdir, name)) as fh:
                out[name.split("_")[-1][:-4]] = " ".join(fh.read().split())
    return out


def load(path):
    z = np.load(path)
    ubm = convert.ubm_from_numpy(z["w"], z["means"], z["covs"], device="cpu")
    return z, torch.tensor(z["feats"]), ubm


def np_(t):
    return t.detach().cpu().numpy()


def bitwise_cfg(data_extent: int, n_utts: int):
    """The ordered-fold contract: one chunk a rank."""
    return CFG.with_overrides(estep_chunk=n_utts // data_extent)


def train_and_extract(cfg, ubm, feats, labels, mesh):
    st = TR.train(cfg, ubm, feats, generator=torch.Generator().manual_seed(
        SEED), mesh=mesh, device="cpu")
    iv = TR.extract(cfg, st, feats, mesh=mesh, device="cpu")
    eer, _ = AR.evaluate_ivectors(cfg, iv, labels, 0)
    return {"T": np_(st.model.T), "Sigma": np_(st.model.Sigma),
            "means": np_(st.ubm.means), "iv": np_(iv), "eer": float(eer)}


def nf(ubm, feats, mesh):
    """Per-utterance n/f of one statistics pass, whole, in rank order."""
    cfg = CFG.with_overrides(estep_chunk=NF_CHUNK)
    fl, _ = TR._place(mesh, feats, None)
    st, _ = TR.stats_ll(cfg, ubm, fl, mesh=mesh)
    return {"n": np_(st.n), "f": np_(st.f)}


def tied(ubm):
    """A UBM whose second half of components repeats the first: every
    diag score ties across the two model ranks of a (1, 2) mesh."""
    h = ubm.weights.shape[0] // 2
    return U.FullGMM(torch.cat([ubm.weights[:h]] * 2),
                     torch.cat([ubm.means[:h]] * 2),
                     torch.cat([ubm.covs[:h]] * 2))


def fused_trajectory(z, ubm, feats, mesh):
    """3 fused iterations from the JAX-drawn T0 (realignment off)."""
    model0 = convert.tvm_from_numpy(z["T0"], z["covs"], z["prior0"],
                                    z["means"], CFG.formulation,
                                    device="cpu")
    TV.init_model = lambda *a, **k: model0
    cfg = CFG.with_overrides(rescore="fused", realign_interval=0,
                             estep_chunk=feats.shape[0] // 2)
    st = TR.train(cfg, ubm, feats, mesh=mesh, device="cpu")
    return {"T": np_(st.model.T), "Sigma": np_(st.model.Sigma)}


def world2_trajectory(path):
    """(2, 1) and (1, 2): the ordered trajectory and the per-utterance
    stats (also on a tied UBM), with the (2, 1) mesh's collective
    counts."""
    mark(path, "trajectory2", "start")
    z, feats, ubm = load(path)
    out = {}
    m21 = MS.make_local_mesh(2, 1, device="cpu")
    m12 = MS.make_local_mesh(1, 2, device="cpu")
    out["train_2x1"] = train_and_extract(bitwise_cfg(2, feats.shape[0]),
                                         ubm, feats, z["labels"], m21)
    mark(path, "trajectory2", "train")
    out["nf_2x1"] = nf(ubm, feats, m21)
    out["nf_1x2"] = nf(ubm, feats, m12)
    out["nf_tied_1x2"] = nf(tied(ubm), feats, m12)
    mark(path, "trajectory2", "nf")
    out["comm"] = {k: list(v) for k, v in m21.comm.items()}
    return out


def supervised(feats, ubm, ckpt_dir, mesh):
    """train_supervised on ``mesh`` with a failure injected after step 1
    of the first attempt."""
    st, rep = TR.train_supervised(
        bitwise_cfg(2, feats.shape[0]), ubm, feats,
        generator=torch.Generator().manual_seed(SEED), ckpt_dir=ckpt_dir,
        mesh=mesh, device="cpu",
        fail_at=lambda step, attempt: step == 1 and attempt == 0)
    return {"T": np_(st.model.T), "Sigma": np_(st.model.Sigma),
            "restarts": rep.n_restarts, "iteration": st.iteration}


def world2_supervised(path, ckpt_dir):
    """(2, 1): the supervised run with an injected failure, then the
    fused trajectory from JAX's T0."""
    mark(path, "supervised2", "start")
    z, feats, ubm = load(path)
    out = {}
    m21 = MS.make_local_mesh(2, 1, device="cpu")
    out["supervised_2x1"] = supervised(feats, ubm, ckpt_dir, m21)
    mark(path, "supervised2", "supervised")
    out["fused_2x1"] = fused_trajectory(z, ubm, feats, m21)
    mark(path, "supervised2", "fused")
    return out


def late_supervised(path, ckpt_dir, delay: float):
    """The supervised (2, 1) run with rank 1 arriving ``delay`` seconds
    after rank 0, which by then could have written the step-0
    checkpoint: the ranks must still agree to start from scratch."""
    _, feats, ubm = load(path)
    m21 = MS.make_local_mesh(2, 1, device="cpu")
    if m21.rank == 1:
        time.sleep(delay)
    return supervised(feats, ubm, ckpt_dir, m21)


def world4(path):
    """(4, 1) and (2, 2): the ordered trajectory, per-utterance stats, the
    three rungs of ``sharded_align_stats`` and one ``em_macro_step``."""
    mark(path, "world4", "start")
    z, feats, ubm = load(path)
    out = {}
    m41 = MS.make_local_mesh(4, 1, device="cpu")
    m22 = MS.make_local_mesh(2, 2, device="cpu")
    out["train_4x1"] = train_and_extract(bitwise_cfg(4, feats.shape[0]),
                                         ubm, feats, z["labels"], m41)
    mark(path, "world4", "train")
    out["nf_4x1"] = nf(ubm, feats, m41)
    out["nf_2x2"] = nf(ubm, feats, m22)
    mark(path, "world4", "nf")
    pre = U.full_precisions(ubm)
    for rescore in EN.RESCORE_LADDER:
        n, f, S = IC.sharded_align_stats(
            CFG.with_overrides(rescore=rescore), m22, ubm.to_diag(), pre,
            feats, second_order=True)
        out[f"align_{rescore}"] = {"n": np_(n), "f": np_(f), "S": np_(S)}
    acc, S = IC.em_macro_step(CFG.with_overrides(estep="packed"), m22,
                              ubm.weights, ubm.means, ubm.covs,
                              torch.tensor(z["T0"]), ubm.covs,
                              torch.tensor(z["prior0"]), feats, utt_chunk=6)
    out["macro_2x2"] = {"A": np_(acc.A), "B": np_(acc.B), "h": np_(acc.h),
                        "S": np_(S)}
    mark(path, "world4", "align and macro-step")
    return out


def failing():
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def stalled():
    """Rank 1 never joins rank 0's collective, and never ends."""
    import time
    if torch.distributed.get_rank() == 1:
        time.sleep(3600)
    torch.distributed.barrier()


def macro_by_op(cfg, utt_chunk: int):
    """One ``em_macro_step`` on a (2, 2) mesh of this world, on inputs of
    ``cfg``'s shapes (``utts_per_batch`` x ``frames_per_utt`` frames)
    drawn from one seed on every rank: the collectives by op the mesh
    counted, {op: [calls, bytes]}."""
    mesh = MS.make_local_mesh(2, 2, device="cpu")
    g = torch.Generator().manual_seed(SEED)
    C, D, R = cfg.n_components, cfg.feat_dim, cfg.ivector_dim
    covs = torch.eye(D).repeat(C, 1, 1)
    prior = torch.zeros(R)
    prior[0] = cfg.prior_offset
    IC.em_macro_step(cfg, mesh, torch.full((C,), 1.0 / C),
                     torch.randn(C, D, generator=g), covs,
                     0.1 * torch.randn(C, D, R, generator=g), covs, prior,
                     torch.randn(cfg.utts_per_batch, cfg.frames_per_utt, D,
                                 generator=g), utt_chunk=utt_chunk)
    return {k: list(v) for k, v in mesh.by_op.items()}
