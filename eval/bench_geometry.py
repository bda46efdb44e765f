"""Per-frame time at a rig geometry, pipelined (on the JAX device).

The flagship bench (bench.py) measures the demonstrator rig (640x480 cam,
720x1280 projector).  The reference's published 2.67 ms/frame, however,
was measured on the ESL static scenes at the ESL eval geometry: 640x480
camera, 1080x1920 projector, 3x-projector rectification (paper Table 2;
.vscode/launch.json:31-34): a 5760x3240 rect frame and a 5760x1080
X-map.  This script times either geometry with the same method as
bench.py (group dispatch, two round sizes differenced, min over trials)
and prints one JSON line.  ``--unsorted`` stages frames in arrival
order (scatter-max) instead of host target-sorted (runs scatter).

Usage:
    python eval/bench_geometry.py --geometry esl   # the paper's Table-2 rig
    python eval/bench_geometry.py --geometry demo  # bench.py's rig
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))



def rig_calibration(geometry: str):
    """Synthetic calibration of the demo rig or the ESL evaluation rig."""
    from xmaps.utils.synthetic import make_synthetic_calibration

    if geometry == "esl":
        # The paper's Table-2 rig: 640x480 camera, 1080x1920 projector,
        # rect = 3x projector (from_esl_yaml semantics) -> (5760, 3240)
        # rect frame, (5760, 1080) X-map.  A synthetic rig stands in for
        # the unreachable upstream calib.yaml (EVAL_ESL.md); the cost
        # profile is set by the geometry, not the intrinsics' values.
        import dataclasses

        calib = make_synthetic_calibration(
            camera_width=640,
            camera_height=480,
            projector_width=1080,
            projector_height=1920,
        )
        calib = dataclasses.replace(
            calib, rect_image_width=3 * 1080, rect_image_height=3 * 1920
        )
    else:
        calib = make_synthetic_calibration(
            camera_width=640,
            camera_height=480,
            projector_width=720,
            projector_height=1280,
        )
    return calib


def rig_frames(calib, n_frames: int, capacity: int, seed: int = 7):
    """``n_frames`` synthetic plane frames at ~28k events (capped below
    ``capacity``), as structured event arrays."""
    from xmaps.utils.synthetic import simulate_plane_events

    rng = np.random.default_rng(seed)
    target = capacity - 1024  # leave headroom below capacity
    frames = []
    for i in range(n_frames):
        ev = simulate_plane_events(
            calib, depth_m=0.45 + 0.02 * i, subsample=0.031, jitter_us=2.0,
            rng=rng,
        )
        if len(ev) > target:
            keep = np.sort(rng.choice(len(ev), size=target, replace=False))
            ev = ev[keep]
        frames.append(ev)
    return frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometry", choices=["esl", "demo"], default="esl")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--events", type=int, default=28 * 1024)
    ap.add_argument("--unsorted", action="store_true",
                    help="arrival-order staging (scatter-max) instead of "
                    "host target-sorted staging (runs scatter)")
    ap.add_argument("--camera-perspective", action="store_true")
    ap.add_argument("--rounds", type=int, nargs=2, default=(6, 30))
    args = ap.parse_args(argv)

    import jax

    from xmaps.models.depth_pipeline import XMapsDepthEngine
    from xmaps.ops.event_batch import EventBatch
    from xmaps.ops.frame_pipeline import depth_frame
    from xmaps.utils.cache import cache_dir, enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    calib = rig_calibration(args.geometry)

    t0 = time.perf_counter()
    engine = XMapsDepthEngine.from_calibration(
        calib,
        event_capacity=args.events,
        z_near=0.2,
        z_far=1.2,
        xmap_cache_dir=cache_dir("tables"),
        camera_perspective=args.camera_perspective,
    )
    setup_s = time.perf_counter() - t0

    events = rig_frames(calib, args.frames, args.events)
    if args.unsorted:
        frames = [
            (EventBatch.from_structured(ev, engine.cfg.event_capacity), None)
            for ev in events
        ]
    else:
        frames = [engine.make_sorted_batch(ev) for ev in events]
    frames = [jax.device_put(bp, dev) for bp in frames]
    n_events = int(np.mean([len(ev) for ev in events]))
    tables, cfg = engine.tables, engine.cfg

    @jax.jit
    def run_group(bs):
        return [
            depth_frame(
                b, tables, cfg, presort_priority=prio,
                presort_runs=prio is not None,
                display_only=True, display_packed=True,
            )
            for b, prio in bs
        ]

    t0 = time.perf_counter()
    out = run_group(frames)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0

    def timed_round(k):
        outs = []
        t0 = time.perf_counter()
        for _ in range(k):
            outs.append(run_group(frames))
            if len(outs) > 3:
                outs.pop(0)
        assert int(outs[-1][-1].num_inliers) > 0, "no inliers"
        return time.perf_counter() - t0

    small, large = args.rounds
    t_small = min(timed_round(small) for _ in range(5))
    t_large = min(timed_round(large) for _ in range(5))
    total_s = t_large - t_small
    n_iters = (large - small) * len(frames)
    frame_ms = total_s / n_iters * 1e3
    mevents_s = n_events * n_iters / total_s / 1e6

    ref_ms = 2.67  # paper Table 2, measured at the ESL geometry
    print(json.dumps({
        "geometry": args.geometry,
        "device_kind": dev.device_kind,
        "frame_ms": frame_ms,
        "mevents_s": mevents_s,
        "events_per_frame": n_events,
        "vs_ref_2p67ms": ref_ms / frame_ms,
        "scatter": "max" if args.unsorted else "runs",
        "tail_crop": list(cfg.tail_crop),
        "rect": [cfg.rect_height, cfg.rect_width],
        "xmap_shape": list(engine.x_map_np.shape),
        "setup_s": round(setup_s, 2),
        "compile_s": round(compile_s, 2),
    }))


if __name__ == "__main__":
    main()
