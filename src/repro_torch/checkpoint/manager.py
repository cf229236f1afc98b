"""Atomic, versioned, integrity-verified checkpoints (the port of
``repro/checkpoint/manager.py``), in the JAX package's on-disk format.

Arrays are written as npz (one file per step) plus a JSON manifest holding
the keys, shapes, dtypes and a sha256 of the array payload. Writes are
atomic (tmp dir + rename). The npz keys are the strings the JAX package
derives from its pytree paths, spelled out here for the trees the system
saves (``flatten``): a bundle's ``{"ubm", "model", "backend"}``, the
trainer's ``{"model", "ubm", "n", "f", "ss"}`` and an LM train state's
nested dicts ``{"params": {...}, "opt": {"m": {...}, "v": {...},
"count"}}`` (keys joined by ``|`` in sorted order, as JAX flattens a
dict). So a checkpoint or bundle written by either package restores in
the other.

Integrity contract: `save` records ``sha256(arrays.npz)`` in the manifest;
`verify`/`restore` refuse torn or tampered checkpoints (missing manifest,
missing/unreadable npz, hash mismatch) with `CheckpointCorruption`.
`CheckpointManager.restore_latest_verified` walks steps newest-first and
falls back to the newest checkpoint that verifies, recording what it
skipped. Retention keeps the last ``keep`` steps plus every
``keep_every``-th step.

On a mesh of several ranks (``CheckpointManager(mesh=...)``) rank 0
alone writes and prunes, and a barrier follows every save: every rank
then restores the same files. The elastic re-mesh of the JAX package:
a save with ``logical_axes`` stores whole arrays (a DTensor leaf is
gathered first, by every rank) and each leaf's axes in the manifest, in
the reference's format; a restore with ``rules`` gives each rank its
shards (DTensors) on the rules' mesh, whatever mesh saved them, and
without rules the whole tensors.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import backend as BK
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U
from repro_torch.launch import mesh as MS

SEP = "|"


class CheckpointCorruption(RuntimeError):
    """A checkpoint failed its integrity check (torn write, bit flip,
    missing manifest); the restore path must fall back, not load it."""


# dtypes numpy cannot hold: stored as unsigned ints of their width, the
# manifest keeping the real name (the JAX package's encoding)
_NONNATIVE = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16),
              "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
              "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8)}
_TORCH_NAME = {v[0]: k for k, v in _NONNATIVE.items()}


def _whole(tree):
    """``tree`` with every DTensor leaf gathered to its whole tensor (a
    collective: every rank of its mesh calls it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return tree


def encode(leaf) -> Tuple[np.ndarray, str]:
    """A leaf (tensor or array) -> (the numpy array stored, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = _TORCH_NAME.get(t.dtype)
        if name is not None:
            _, int_dt, np_dt = _NONNATIVE[name]
            return t.view(int_dt).numpy().view(np_dt), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype_name: str, dev) -> torch.Tensor:
    if dtype_name in _NONNATIVE:
        dt, int_dt, _ = _NONNATIVE[dtype_name]
        if int_dt == torch.int16:   # torch has no uint16 view to bf16
            arr = arr.view(np.int16)
        return torch.from_numpy(arr).view(dt).to(dev)
    return torch.from_numpy(arr).to(dev)


# ---------------------------------------------------------------------------
# The saved trees, flattened to the JAX package's key strings
# ---------------------------------------------------------------------------


def _flatten_value(name: str, v) -> Dict[str, object]:
    from repro_torch.api.artifacts import BackendArtifact  # api imports us
    if isinstance(v, U.FullGMM):
        return {f"{name}|0": v.weights, f"{name}|1": v.means,
                f"{name}|2": v.covs}
    if isinstance(v, TV.TVModel):   # formulation is not a leaf
        return {f"{name}|0": v.T, f"{name}|1": v.Sigma,
                f"{name}|2": v.prior, f"{name}|3": v.means}
    if isinstance(v, BackendArtifact):
        out = {f"{name}|0": v.mu,
               f"{name}|1|.mean": v.lda.mean, f"{name}|1|.proj": v.lda.proj,
               f"{name}|2|.mean": v.plda.mean, f"{name}|2|.B": v.plda.B,
               f"{name}|2|.W": v.plda.W}
        if v.whitener is not None:
            out[f"{name}|3"] = v.whitener
        return out
    if isinstance(v, dict):         # JAX flattens a dict in sorted order
        out = {}
        for k in sorted(v):
            out.update(_flatten_value(f"{name}{SEP}{k}", v[k]))
        return out
    return {name: v}


def flatten(tree: Dict) -> Dict[str, object]:
    """{name: FullGMM | TVModel | BackendArtifact | dict | tensor} ->
    {key: leaf}, keyed as the JAX package's ``tree_flatten_with_path``
    keys them."""
    flat: Dict[str, object] = {}
    for name in sorted(tree):
        flat.update(_flatten_value(name, tree[name]))
    return flat


def _unflatten_value(name: str, like, leaves: Dict):
    from repro_torch.api.artifacts import BackendArtifact
    if isinstance(like, U.FullGMM):
        return U.FullGMM(*(leaves[f"{name}|{i}"] for i in range(3)))
    if isinstance(like, TV.TVModel):
        return TV.TVModel(*(leaves[f"{name}|{i}"] for i in range(4)),
                          formulation=like.formulation)
    if isinstance(like, BackendArtifact):
        return BackendArtifact(
            mu=leaves[f"{name}|0"],
            lda=BK.LDA(leaves[f"{name}|1|.mean"], leaves[f"{name}|1|.proj"]),
            plda=BK.PLDA(leaves[f"{name}|2|.mean"], leaves[f"{name}|2|.B"],
                         leaves[f"{name}|2|.W"]),
            whitener=(None if like.whitener is None
                      else leaves[f"{name}|3"]))
    if isinstance(like, dict):
        return {k: _unflatten_value(f"{name}{SEP}{k}", sub, leaves)
                for k, sub in like.items()}
    return leaves[name]


def unflatten(tree_like: Dict, leaves: Dict) -> Dict:
    """Inverse of `flatten`: ``tree_like`` supplies the structure (and a
    TVModel's formulation, a backend's whitener or its absence)."""
    return {name: _unflatten_value(name, like, leaves)
            for name, like in tree_like.items()}


# ---------------------------------------------------------------------------
# Save / verify / restore
# ---------------------------------------------------------------------------


def save(ckpt_dir, step: int, tree, logical_axes=None,
         extra: Optional[Dict] = None) -> Path:
    """Atomic checkpoint write of ``tree`` (see `flatten`; DTensor leaves
    must come gathered, as ``CheckpointManager`` gathers them).
    ``logical_axes``: a tree of the same structure holding axis tuples
    (or None), stored for elastic restore."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    arrays = {k: encode(v) for k, v in flatten(tree).items()}
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(a.shape), "dtype": name}
                 for k, (a, name) in arrays.items()},
        "extra": extra or {},
    }
    if logical_axes is not None:
        manifest["axes"] = {k: list(v) if v is not None else None
                            for k, v in flatten(logical_axes).items()}
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        np.savez(tmp / "arrays.npz", **{k: a for k, (a, _) in arrays.items()})
        manifest["integrity"] = {
            "algo": "sha256",
            "arrays.npz": _file_sha256(tmp / "arrays.npz"),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return ckpt_dir / f"step_{step:08d}"


def _file_sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def clean_stale_tmp(ckpt_dir) -> List[str]:
    """Remove orphaned ``.tmp_*`` staging dirs, the debris of a writer
    killed before its atomic rename (invisible to `latest_step` and
    `restore`). Only call when no save can be in flight. Returns the
    removed names."""
    ckpt_dir = Path(ckpt_dir)
    removed: List[str] = []
    if not ckpt_dir.exists():
        return removed
    for p in ckpt_dir.glob(".tmp_*"):
        if p.is_dir():
            shutil.rmtree(p, ignore_errors=True)
            removed.append(p.name)
    return removed


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def all_steps(ckpt_dir) -> List[int]:
    """Every on-disk step, ascending (verified or not)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(int(p.name.split("_")[1])
                  for p in ckpt_dir.glob("step_*"))


def verify(ckpt_dir, step: int) -> Dict:
    """Integrity-check one checkpoint; returns its manifest or raises
    `CheckpointCorruption`. Checks: manifest present and parseable,
    arrays.npz present, payload sha256 matches the manifest (manifests
    without an integrity record skip the hash comparison), and the npz is
    structurally loadable (torn-write detection)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    mpath, apath = d / "manifest.json", d / "arrays.npz"
    if not mpath.exists():
        raise CheckpointCorruption(f"{d}: manifest.json missing")
    try:
        manifest = json.loads(mpath.read_text())
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruption(f"{d}: unreadable manifest: {e}") from e
    if not apath.exists():
        raise CheckpointCorruption(f"{d}: arrays.npz missing")
    integrity = manifest.get("integrity")
    if integrity is not None:
        got = _file_sha256(apath)
        want = integrity.get("arrays.npz")
        if got != want:
            raise CheckpointCorruption(
                f"{d}: arrays.npz sha256 mismatch (stored "
                f"{str(want)[:12]}.., recomputed {got[:12]}..)")
    try:
        with np.load(apath) as data:
            missing = set(manifest.get("keys", {})) - set(data.files)
    except Exception as e:   # zipfile/ValueError: torn or truncated npz
        raise CheckpointCorruption(f"{d}: torn arrays.npz: {e}") from e
    if missing:
        raise CheckpointCorruption(
            f"{d}: arrays.npz missing keys {sorted(missing)[:4]}")
    return manifest


def latest_verified_step(ckpt_dir) -> Optional[int]:
    """Newest step that passes `verify` (None if none do)."""
    for step in reversed(all_steps(ckpt_dir)):
        try:
            verify(ckpt_dir, step)
            return step
        except CheckpointCorruption:
            continue
    return None


def restore(ckpt_dir, tree_like, step: Optional[int] = None, rules=None,
            check: bool = True, device=None):
    """Restore into the structure of ``tree_like`` (values unused but for
    a TVModel's formulation and a backend's whitener), tensors on
    ``device`` (CUDA unless the caller names another). ``check`` (default)
    integrity-verifies the checkpoint first. With ``rules`` of several
    ranks, each leaf with stored axes comes back as this rank's shards (a
    DTensor on the rules' mesh, its placements rebuilt from the axes),
    on the mesh's device. Returns (tree, step, extra)."""
    distributed = rules is not None and rules.distributed
    dev = rules.mesh.device if distributed else resolve_device(device)
    ckpt_dir = Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    if check:
        verify(ckpt_dir, step)
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as data:
        leaves = {k: _decode(data[k], manifest["keys"][k]["dtype"], dev)
                  for k in flatten(tree_like)}
    axes = manifest.get("axes", {})
    if distributed:
        leaves = {k: (rules.distribute(v, tuple(axes[k]))
                      if axes.get(k) is not None else v)
                  for k, v in leaves.items()}
    return unflatten(tree_like, leaves), step, manifest.get("extra", {})


class CheckpointManager:
    """Interval-based manager with retention, integrity verification and
    restart support.

    Retention: the newest ``keep`` checkpoints always survive GC; with
    ``keep_every`` > 0, steps divisible by it are also retained (the
    fall-back targets when the newest checkpoint is found corrupted).

    ``mesh`` (a ``launch.mesh.Mesh`` of several ranks): every rank
    gathers the DTensor leaves, rank 0 writes and prunes, then every rank
    waits at a barrier, so a save returns once the checkpoint is on disk
    for all. ``logical_axes`` are stored with every save; ``rules``
    restore each rank's shards (module docstring)."""

    def __init__(self, ckpt_dir, save_interval: int = 100, keep: int = 3,
                 logical_axes=None, rules=None, keep_every: int = 0,
                 device=None, mesh=None):
        self.dir = Path(ckpt_dir)
        self.logical_axes = logical_axes
        self.rules = rules
        self.save_interval = save_interval
        self.keep = keep
        self.keep_every = keep_every
        self.device = device
        self.mesh = mesh
        # steps restore_latest_verified skipped as corrupted, most recent
        # restore first
        self.skipped_corrupt: List[int] = []

    @property
    def writer(self) -> bool:
        """Whether this process writes: rank 0 of the mesh, or the only
        process."""
        return self.mesh is None or self.mesh.rank == 0

    def sync(self) -> None:
        """Wait for every rank of the mesh (nothing without one)."""
        if self.mesh is not None:
            MS.barrier(self.mesh)

    def maybe_save(self, step: int, tree, extra=None, force=False):
        if not force and (step % self.save_interval != 0):
            return None
        p = self.dir / f"step_{step:08d}"
        tree = _whole(tree)
        if self.writer:
            p = save(self.dir, step, tree, self.logical_axes, extra)
            self._gc()
        self.sync()
        return p

    def _gc(self):
        steps = all_steps(self.dir)
        kept = set(steps[-self.keep:] if self.keep > 0 else [])
        if self.keep_every > 0:
            kept.update(s for s in steps if s % self.keep_every == 0)
        for s in steps:
            if s not in kept:
                shutil.rmtree(self.dir / f"step_{s:08d}",
                              ignore_errors=True)

    def steps(self) -> List[int]:
        return all_steps(self.dir)

    def verify_step(self, step: int) -> Dict:
        return verify(self.dir, step)

    def restore_latest(self, tree_like):
        """Restore the newest checkpoint; raises `CheckpointCorruption` if
        it fails integrity (use `restore_latest_verified` to fall back)."""
        return restore(self.dir, tree_like, rules=self.rules,
                       device=self.device)

    def restore_latest_verified(self, tree_like):
        """Restore the newest checkpoint that verifies, walking past
        corrupted ones (recorded in ``self.skipped_corrupt``). Raises
        `FileNotFoundError` when no checkpoint exists at all and
        `CheckpointCorruption` when every on-disk checkpoint is corrupt."""
        steps = all_steps(self.dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        self.skipped_corrupt = []
        for step in reversed(steps):
            try:
                verify(self.dir, step)
            except CheckpointCorruption:
                self.skipped_corrupt.append(step)
                continue
            return restore(self.dir, tree_like, step=step, rules=self.rules,
                           check=False, device=self.device)
        raise CheckpointCorruption(
            f"every checkpoint under {self.dir} is corrupt "
            f"(steps {self.skipped_corrupt})")

    def has_checkpoint(self) -> bool:
        return latest_step(self.dir) is not None
