"""I-vector serving launcher: batched variable-length extraction session
(the port of ``repro/launch/serve_ivector.py``, with its flags and
``--device``).

  * ``--bundle PATH``: serve a versioned artifact bundle produced by a
    training run (either package's `recipe.run(bundle_dir=...)` or
    `Bundle.save`). No training happens here.
  * default: train a small (UBM, TVM) pair, save it as a bundle
    (``--save-bundle``), and serve from that bundle, so the demo goes
    through the portable-artifact round trip too.

Either way the session is an ``IVectorExtractor`` on ``--device`` (CUDA
unless named) driven by ragged synthetic requests, reporting throughput,
real-time factor and bucket statistics; ``--streaming`` feeds chunked
streams through the crash-safe session store and the admission queue.

    PYTHONPATH=src python -m repro_torch.launch.serve_ivector --smoke \\
        --batch 8 --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve_ivector --smoke \\
        --streaming --journal-dir out/journal
    PYTHONPATH=src python -m repro_torch.launch.serve_ivector \\
        --bundle out/bundle
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.bundle import Bundle, peek
from repro_torch.configs.ivector_tvm import CONFIG, SMOKE, IVectorConfig
from repro_torch.core import trainer as TR
from repro_torch.core import ubm as U
from repro_torch.data.speech import (FRAME_RATE, SpeechDataConfig,
                                     build_ragged_dataset)
from repro_torch.serving import (AdmissionQueue, IVectorExtractor, QueueFull,
                                 ServingConfig, SessionConfig, SessionStore)


def build_state(cfg, data_cfg, train_iters: int, device):
    """Synthetic ragged corpus + quickly-trained (UBM, TVM) pair; the
    utterances come back as float32 numpy."""
    utts, labels = build_ragged_dataset(data_cfg, device)
    frames = torch.cat(utts, dim=0)
    # the demo: fixed seeds keep the served model reproducible
    ubm = U.train_ubm(frames, cfg.n_components,
                      # repro-check: disable=SRC002
                      torch.Generator().manual_seed(0), diag_iters=4,
                      full_iters=2, device=device)
    # fixed-length training block (the service is where ragged lengths live)
    fixed = torch.stack([u[:data_cfg.min_frames_per_utt] for u in utts])
    state = TR.train(cfg, ubm, fixed, n_iters=train_iters,
                     # repro-check: disable=SRC002
                     generator=torch.Generator().manual_seed(0),
                     device=device)
    return state, [u.cpu().numpy() for u in utts], labels


def serve_streaming(ex, utts, args):
    """Streaming mode: every utterance becomes a live stream of
    --chunk-frames chunks fed through the session store via the admission
    queue. First chunks are submitted as 'first' (a user is waiting),
    later ones as 'refine' (sheddable under overload); the loop drains
    with the adaptive batch budget each tick. With --journal-dir, a killed
    process restarts into the same sessions."""
    store = SessionStore(ex, SessionConfig(
        chunk_min_bucket=min(args.min_bucket, args.chunk_frames),
        journal_dir=args.journal_dir))
    if store.stats["restored"]:
        print(f"  restored {store.stats['restored']} live sessions "
              f"from {args.journal_dir} "
              f"(torn tails dropped: {store.stats['journal_torn']})")
    q = AdmissionQueue(ex, max_pending=args.max_pending or 64,
                       default_timeout=args.deadline, store=store)
    streams = {f"stream-{i}": np.asarray(u, np.float32)
               for i, u in enumerate(utts)}
    cursors = {sid: 0 for sid in streams}
    t0 = time.time()
    first_iv_s, served = {}, 0
    while cursors:
        for sid in list(cursors):       # round-robin: one chunk each
            u, at = streams[sid], cursors[sid]
            chunk = u[at:at + args.chunk_frames]
            if chunk.shape[0] == 0:
                store.close(sid)
                del cursors[sid]
                continue
            try:
                q.submit(chunk, kind="first" if at == 0 else "refine",
                         sid=sid)
            except QueueFull:
                continue                # refine chunk sheds; retried next
            cursors[sid] = at + args.chunk_frames
        for r in q.drain(q.batch_budget()).values():
            if r.ivector is not None:
                served += 1
                if r.sid not in first_iv_s:
                    first_iv_s[r.sid] = time.time() - t0
        while len(q):                   # flush leftovers before next round
            for r in q.drain(q.batch_budget()).values():
                served += r.ivector is not None
    wall = time.time() - t0
    frames = sum(u.shape[0] for u in streams.values())
    print(f"streamed {len(streams)} sessions ({frames} frames) "
          f"in {wall:.3f}s — {served} incremental i-vectors emitted")
    if first_iv_s:
        tfirst = sorted(first_iv_s.values())
        print(f"  time-to-first-ivector: p50 "
              f"{tfirst[len(tfirst) // 2]:.3f}s  "
              f"max {tfirst[-1]:.3f}s")
    h = q.health()
    print(f"  readiness payload: ok={h['ok']} mode={h['mode']} "
          f"queue={h['queue']}")
    print(f"  sessions: {h['sessions']['stats']}")
    store.close_store()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    ap.add_argument("--bundle", default=None,
                    help="serve this saved artifact bundle (skips training)")
    ap.add_argument("--save-bundle", default=None,
                    help="where the demo-trained bundle is written "
                         "(default: ivector_serve_bundle in the temp dir)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--min-bucket", type=int, default=32)
    ap.add_argument("--train-iters", type=int, default=1)
    ap.add_argument("--max-pending", type=int, default=0,
                    help="admission-queue capacity (0 = direct extract, "
                         "no queue)")
    ap.add_argument("--deadline", type=float, default=30.0,
                    help="per-request deadline in seconds (queue mode)")
    ap.add_argument("--streaming", action="store_true",
                    help="serve chunked streams through the crash-safe "
                         "session store instead of whole utterances")
    ap.add_argument("--chunk-frames", type=int, default=40,
                    help="frames per streamed chunk (streaming mode)")
    ap.add_argument("--journal-dir", default=None,
                    help="write-ahead session journal dir (streaming "
                         "mode); restart with the same dir to restore "
                         "live sessions bit-exact")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.bundle is not None:
        # manifest-only read for the banner/config; the arrays are loaded
        # (and integrity-checked) exactly once, by from_bundle below
        extra = peek(args.bundle)
        cfg = IVectorConfig(**extra["config"]).validate()
        print(f"serving bundle {args.bundle} "
              f"(schema v{extra['schema_version']}, "
              f"C={cfg.n_components}, R={cfg.ivector_dim}, "
              f"seed={extra.get('provenance', {}).get('seed')})")
    else:
        cfg = SMOKE if args.smoke else CONFIG
    data_cfg = SpeechDataConfig(
        feat_dim=cfg.feat_dim, n_components=max(8, cfg.n_components // 2),
        n_speakers=8 if args.smoke else 40,
        utts_per_speaker=max(2, args.requests // (8 if args.smoke else 40)),
        frames_per_utt=160 if args.smoke else 1024,
        min_frames_per_utt=40 if args.smoke else 256,
        speaker_rank=6 if args.smoke else 16,
        channel_rank=3 if args.smoke else 8)
    if args.bundle is not None:
        bundle_path = args.bundle
        utts = [u.cpu().numpy()
                for u in build_ragged_dataset(data_cfg, dev)[0]]
    else:
        state, utts, _ = build_state(cfg, data_cfg, args.train_iters, dev)
        save_to = (Path(args.save_bundle) if args.save_bundle is not None
                   else Path(tempfile.gettempdir()) / "ivector_serve_bundle")
        bundle_path = Bundle(
            cfg=cfg, ubm=state.ubm, model=state.model,
            provenance={"recipe": "serve_ivector-demo", "seed": 0,
                        "n_iters": args.train_iters}).save(save_to)
        print(f"saved demo bundle -> {bundle_path}")
    utts = utts[:args.requests]

    # serving always consumes the bundle, never loose in-memory arrays
    ex = IVectorExtractor.from_bundle(
        bundle_path, ServingConfig(max_batch=args.batch,
                                   min_bucket=args.min_bucket), device=dev)
    # readiness probe before traffic: the canary runs the same path as
    # real requests, so a broken fused kernel demotes here, not mid-load
    health = ex.health_check()
    print(f"  readiness: ok={health['ok']} mode={health['mode']} "
          f"canary latency {health['latency_s']:.3f}s")
    if not health["ok"]:
        raise SystemExit(f"serving session unhealthy: {health}")
    if args.streaming:
        serve_streaming(ex, utts, args)
        return
    t0 = time.time()
    ex.extract(utts)                    # cold pass: first use of each bucket
    cold = time.time() - t0
    if args.max_pending > 0:
        # admission-controlled serving: bounded queue + deadlines; shed
        # requests are reported, never silently dropped
        q = AdmissionQueue(ex, max_pending=args.max_pending,
                           default_timeout=args.deadline)
        ids, shed = [], 0
        t0 = time.time()
        results = {}
        for u in utts:
            try:
                ids.append(q.submit(u))
            except QueueFull:
                shed += 1
                results.update(q.drain())   # one batching tick, then retry
                ids.append(q.submit(u))
        results.update(q.drain())
        wall = time.time() - t0
        served = [results[i] for i in ids if not results[i].expired]
        ivecs = np.stack([r.ivector for r in served])
        print(f"  admission: {q.stats} (hit capacity {shed}x)")
    else:
        t0 = time.time()
        ivecs = ex.extract(utts)        # steady state
        wall = time.time() - t0
    frames = sum(u.shape[0] for u in utts)
    audio_s = frames / FRAME_RATE
    print(f"served {len(utts)} utterances ({frames} frames, "
          f"{audio_s:.1f}s audio) in {wall:.3f}s "
          f"(cold pass: {cold:.3f}s)")
    print(f"  throughput: {len(utts) / wall:.1f} utts/s, "
          f"real-time factor {audio_s / wall:.1f}x")
    print(f"  buckets: {ex.buckets()}  stats: {ex.stats}")
    print(f"  guardrails: mode={ex.mode} "
          f"degradations={ex.stats['degradations']} "
          f"truncated={ex.stats['truncated']} "
          f"nonfinite_frames={ex.stats['nonfinite_frames']}")
    print(f"  ivector shape: {ivecs.shape}, "
          f"norms ~ {np.linalg.norm(ivecs, axis=1).mean():.3f}")


if __name__ == "__main__":
    main()
