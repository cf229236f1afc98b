"""Versioned train-once / serve-anywhere artifact bundle (the port of
``repro/api/bundle.py``), in the JAX package's format.

A `Bundle` is the single portable output of a training run: config + UBM +
total-variability model + (optional) scoring backend + provenance, written
through `checkpoint/manager.py` (atomic tmp-dir + rename, npz arrays + a
JSON manifest). Serving consumes it directly
(`IVectorExtractor.from_bundle(path)`), so the extraction a bundle yields
is bitwise that of the in-memory session that saved it. The keys, the
manifest and `content_hash` are the JAX package's, so a bundle saved by
either package loads in the other.

Schema versioning: ``schema_version`` is bumped on any change to the
stored tree structure or the meaning of a stored field; the loader accepts
only versions it knows (<= SCHEMA_VERSION) and fails loudly otherwise.
Array payloads are integrity-hashed (``content_hash``) at save and
verified at load.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.artifacts import SCHEMA_VERSION, BackendArtifact
from repro_torch.checkpoint import manager as CM
from repro_torch.configs.ivector_tvm import IVectorConfig
from repro_torch.core import backend as BK
from repro_torch.core import tvm as TV
from repro_torch.core import ubm as U

_STEP = 0   # a bundle is a single-step checkpoint


@dataclass
class Bundle:
    """One portable trained artifact: everything serving needs."""
    cfg: IVectorConfig
    ubm: U.FullGMM
    model: TV.TVModel
    backend: Optional[BackendArtifact] = None
    provenance: Dict = field(default_factory=dict)

    # -- save ---------------------------------------------------------------

    def _tree(self) -> Dict:
        tree = {"ubm": self.ubm, "model": self.model}
        if self.backend is not None:
            tree["backend"] = self.backend
        return tree

    def save(self, path) -> Path:
        """Write the bundle under ``path`` (atomic). Returns the path."""
        path = Path(path)
        tree = self._tree()
        extra = {
            "schema_version": SCHEMA_VERSION,
            "kind": "ivector-bundle",
            "config": dataclasses.asdict(self.cfg),
            "formulation": self.model.formulation,
            "has_backend": self.backend is not None,
            "has_whitener": (self.backend is not None
                             and self.backend.whitener is not None),
            "content_hash": content_hash(tree),
            "provenance": dict(self.provenance,
                               schema_version=SCHEMA_VERSION,
                               created_unix=time.time(),
                               torch_version=torch.__version__),
        }
        CM.save(path, _STEP, tree, extra=extra)
        return path

    # -- load ---------------------------------------------------------------

    @classmethod
    def load(cls, path, verify: bool = True, device=None) -> "Bundle":
        """Load and schema/integrity-check a saved bundle onto ``device``
        (CUDA unless the caller names another)."""
        path = Path(path)
        dev = resolve_device(device)
        extra = peek(path)
        cfg = IVectorConfig(**extra["config"]).validate()
        tree, _, extra2 = CM.restore(path, _skeleton(extra), step=_STEP,
                                     device=dev)
        bundle = cls(cfg=cfg, ubm=tree["ubm"], model=tree["model"],
                     backend=tree.get("backend"),
                     provenance=extra2.get("provenance", {}))
        if verify:
            got = content_hash(bundle._tree())
            want = extra.get("content_hash")
            if want and got != want:
                raise ValueError(
                    f"bundle {path} failed integrity check: stored "
                    f"content_hash {want[:12]}.. != recomputed {got[:12]}..")
        return bundle


def peek(path) -> Dict:
    """Read a bundle's manifest ``extra`` (schema, config, provenance)
    without loading any arrays; raises on unknown schema versions."""
    path = Path(path)
    step = CM.latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no bundle under {path}")
    manifest = json.loads(
        (path / f"step_{step:08d}" / "manifest.json").read_text())
    extra = manifest.get("extra", {})
    ver = extra.get("schema_version")
    if extra.get("kind") != "ivector-bundle" or ver is None:
        raise ValueError(f"{path} is not an i-vector bundle "
                         f"(kind={extra.get('kind')!r})")
    if not isinstance(ver, int) or ver < 1 or ver > SCHEMA_VERSION:
        raise ValueError(
            f"bundle {path} has schema_version={ver!r}; this build "
            f"supports 1..{SCHEMA_VERSION} — refusing a best-effort load")
    return extra


def content_hash(tree) -> str:
    """Deterministic sha256 over the flattened array payload (keys joined
    with '/' and sorted, dtype+shape+bytes per leaf): the bundle's
    integrity fingerprint, the JAX package's digest for the same arrays."""
    items = [(key.replace(CM.SEP, "/"), CM.encode(leaf))
             for key, leaf in CM.flatten(tree).items()]
    h = hashlib.sha256()
    for key, (arr, name) in sorted(items, key=lambda kv: kv[0]):
        arr = np.ascontiguousarray(arr)
        h.update(key.encode())
        h.update(name.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _skeleton(extra: Dict) -> Dict:
    """Structure-only tree matching the saved bundle (restore takes the
    shapes from the npz; the skeleton supplies the structure and the model
    formulation)."""
    z = torch.zeros(())
    tree = {"ubm": U.FullGMM(z, z, z),
            "model": TV.TVModel(T=z, Sigma=z, prior=z, means=z,
                                formulation=extra["formulation"])}
    if extra.get("has_backend"):
        tree["backend"] = BackendArtifact(
            mu=z, lda=BK.LDA(z, z), plda=BK.PLDA(z, z, z),
            whitener=z if extra.get("has_whitener") else None)
    return tree
