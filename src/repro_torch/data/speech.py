"""Synthetic VoxCeleb-like speaker data (the port of ``repro/data/speech.py``).

Frames are drawn from a global full-covariance GMM whose component means
are shifted per speaker by a low-rank speaker subspace (plus a smaller
per-utterance channel subspace): the generative family i-vectors model.

``FRAME_RATE``, ``SpeechDataConfig`` and ``make_trials`` are copies of the
JAX package's, so the same ``np.random.default_rng(seed)`` draws the same
trials in both packages. The generator draws the same distributions from
``torch.Generator``s on the CPU instead of JAX keys, so its frames are not
bitwise the JAX package's: the two PRNGs differ. Its draws do not depend on
the device the frames end up on; utterance (s, u) has a generator of its
own, seeded from (seed + 1, s, u), so a dataset is deterministic per
utterance. ``iter_batches`` cuts a batch into macro-batches and
``prefetch_to_device`` keeps the next ones' host-to-device copies in
flight while the current one is consumed.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

f32 = torch.float32

# frames per second of audio the features stand in for (10 ms hop, paper
# setup); real-time factors everywhere are computed against this
FRAME_RATE = 100.0


@dataclass(frozen=True)
class SpeechDataConfig:
    feat_dim: int = 20
    n_components: int = 32     # true generator components
    n_speakers: int = 40
    utts_per_speaker: int = 12
    frames_per_utt: int = 200
    # ragged traffic: when set (< frames_per_utt), utterance lengths are
    # drawn uniformly from [min_frames_per_utt, frames_per_utt] — the
    # variable-length regime the serving path buckets and masks
    min_frames_per_utt: Optional[int] = None
    speaker_rank: int = 16
    channel_rank: int = 8
    speaker_scale: float = 1.6
    channel_scale: float = 0.6
    seed: int = 0


def _cpu_generator(*seed: int) -> torch.Generator:
    state = np.random.SeedSequence(list(seed)).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def make_generator(cfg: SpeechDataConfig, device=None):
    """Returns (gen_params, sample_utterance(speaker_id, generator)); the
    parameters live on ``device``, the random draws come from CPU
    generators."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(cfg.seed)
    C, D = cfg.n_components, cfg.feat_dim

    def randn(*shape, gen=g):
        return torch.randn(shape, generator=gen, dtype=f32).to(dev)

    means = randn(C, D) * 2.0
    # well-conditioned random covariances
    A = randn(C, D, D) * 0.3
    covs = (torch.einsum("cij,ckj->cik", A, A)
            + 0.5 * torch.eye(D, device=dev)[None])
    chols = torch.linalg.cholesky(covs)
    V = randn(C, D, cfg.speaker_rank) * (cfg.speaker_scale
                                         / np.sqrt(cfg.speaker_rank))
    Wc = randn(C, D, cfg.channel_rank) * (cfg.channel_scale
                                          / np.sqrt(cfg.channel_rank))
    spk_vecs = randn(cfg.n_speakers, cfg.speaker_rank)

    def sample_utterance(speaker_id: int, gen: torch.Generator):
        ch = randn(cfg.channel_rank, gen=gen)
        mu_spk = (means + torch.einsum("cdr,r->cd", V, spk_vecs[speaker_id])
                  + torch.einsum("cdr,r->cd", Wc, ch))
        # uniform component weights: a categorical draw over C
        comp = torch.randint(C, (cfg.frames_per_utt,), generator=gen).to(dev)
        eps = randn(cfg.frames_per_utt, D, gen=gen)
        return mu_spk[comp] + torch.einsum("fij,fj->fi", chols[comp], eps)

    return {"means": means, "covs": covs, "V": V}, sample_utterance


def build_dataset(cfg: SpeechDataConfig, device=None
                  ) -> Tuple[torch.Tensor, np.ndarray]:
    """Returns (features [U, F, D] on ``device``, speaker_labels [U])."""
    _, sample = make_generator(cfg, device)
    feats, labels = [], []
    for s in range(cfg.n_speakers):
        for u in range(cfg.utts_per_speaker):
            feats.append(sample(s, _cpu_generator(cfg.seed + 1, s, u)))
            labels.append(s)
    return torch.stack(feats), np.asarray(labels)


def utterance_lengths(cfg: SpeechDataConfig) -> np.ndarray:
    """Deterministic per-utterance frame counts [U] (row-major speaker/utt
    order, same as ``build_dataset``). Uniform over
    [min_frames_per_utt, frames_per_utt]; degenerate (all equal) when the
    ragged range is unset. Numpy, so equal to the JAX package's."""
    U = cfg.n_speakers * cfg.utts_per_speaker
    if cfg.min_frames_per_utt is None:
        return np.full((U,), cfg.frames_per_utt, np.int64)
    rng = np.random.default_rng(cfg.seed + 7919)
    return rng.integers(cfg.min_frames_per_utt, cfg.frames_per_utt + 1,
                        size=U)


def build_ragged_dataset(cfg: SpeechDataConfig, device=None
                         ) -> Tuple[List[torch.Tensor], np.ndarray]:
    """Variable-length variant of ``build_dataset``: (list of [F_i, D]
    utterances, speaker_labels [U]); utterance i is the fixed-length
    sample truncated to its drawn length."""
    fixed, labels = build_dataset(cfg, device)
    lengths = utterance_lengths(cfg)
    return [fixed[i, :int(n)] for i, n in enumerate(lengths)], labels


def iter_batches(feats, mask=None, batch: int = 0):
    """Yield (feats_b, mask_b) macro-batch slices of [U, F, D] features in
    utterance order. ``batch`` <= 0 yields the whole array once; a ragged
    tail is yielded as it is (the engine's masked chunk body is exact on
    any batch size). ``mask_b`` is None when ``mask`` is None."""
    U = feats.shape[0]
    if batch <= 0 or batch >= U:
        yield feats, mask
        return
    for s in range(0, U, batch):
        e = min(s + batch, U)
        yield feats[s:e], (None if mask is None else mask[s:e])


def prefetch_to_device(it, size: int = 2, device=None):
    """Prefetching host -> device copies of an iterator of tuples of
    tensors (None elements pass through).

    On a CUDA ``device`` each element is copied from pinned host memory on
    a side stream as soon as it is drawn, with up to ``size`` elements in
    flight, so the next macro-batch's copy overlaps the current one's
    compute; the consumer's stream waits on the element's copy event
    before it is yielded. On the CPU (``device`` None or ``cpu``) the
    elements pass through as tensors. ``size`` < 2 copies each element
    when it is drawn, with nothing ahead.
    """
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        for batch in it:
            yield tuple(None if x is None else torch.as_tensor(x)
                        for x in batch)
        return
    side = torch.cuda.Stream(dev)

    def copy(x):
        x = torch.as_tensor(x)
        return (x if x.is_cuda else x.pin_memory()).to(dev, non_blocking=True)

    def put(batch):
        with torch.cuda.stream(side):
            out = tuple(None if x is None else copy(x) for x in batch)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def take(item):
        out, done = item
        cur = torch.cuda.current_stream(dev)
        cur.wait_event(done)
        for x in out:
            if x is not None:
                x.record_stream(cur)   # allocated on the side stream
        return out

    buf = deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= max(size, 1):
            yield take(buf.popleft())
    while buf:
        yield take(buf.popleft())


def make_trials(labels: np.ndarray, ivec_ids: np.ndarray, rng: np.random.Generator,
                n_trials: int = 20000) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Balanced target/nontarget trial list over utterance indices."""
    n = len(labels)
    by_spk = {}
    for i, s in enumerate(labels):
        by_spk.setdefault(int(s), []).append(i)
    tar_a, tar_b = [], []
    non_a, non_b = [], []
    half = n_trials // 2
    spks = list(by_spk)
    while len(tar_a) < half:
        s = spks[rng.integers(len(spks))]
        if len(by_spk[s]) < 2:
            continue
        i, j = rng.choice(by_spk[s], 2, replace=False)
        tar_a.append(i), tar_b.append(j)
    while len(non_a) < half:
        s1, s2 = rng.choice(spks, 2, replace=False)
        non_a.append(by_spk[int(s1)][rng.integers(len(by_spk[int(s1)]))])
        non_b.append(by_spk[int(s2)][rng.integers(len(by_spk[int(s2)]))])
    a = np.asarray(tar_a + non_a)
    b = np.asarray(tar_b + non_b)
    y = np.concatenate([np.ones(half), np.zeros(half)])
    return a, b, y
