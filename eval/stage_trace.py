"""Device time per pipeline stage, read from a profiler trace.

Runs each stage of the projector-view frame program as its own jitted
program over pre-staged frames at one rig geometry, traces each in a
session of its own, and reduces the trace to device time per call:

- ``event_stage``: rectify (packed camera LUT gather) + X-map lookup +
  disparity, the per-event stage of ops.frame_pipeline;
- ``scatter_max``: the duplicate-capable scatter-max of arrival-order
  frames into the tail's crop window;
- ``scatter_runs``: the sort-free runs scatter of host target-sorted
  frames;
- ``frame``: the whole display frame program (host target-sorted
  staging).

A session's device time is the sum of the kernel durations on the GPU's
stream lines; ``busy_us`` is the union of those intervals, so concurrent
streams are not counted twice.  Prints one JSON line.  Needs a GPU: on
any other platform it exits non-zero.

Usage:
    python eval/stage_trace.py --geometry esl   # traces under .cache/trace
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_time(trace_dir: str, calls: int) -> dict:
    """Per-call device kernel time of the newest trace under trace_dir."""
    from jax.profiler import ProfileData

    path = max(
        glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True),
        key=os.path.getmtime,
    )
    total_ns = 0.0
    intervals = []
    kernels = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                total_ns += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                kernels[ev.name] = kernels.get(ev.name, 0.0) + ev.duration_ns
    busy_ns, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e > end:
            busy_ns += e - max(s, end)
            end = e
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return {
        "kernel_us": total_ns / calls / 1e3,
        "busy_us": busy_ns / calls / 1e3,
        "launches": len(intervals) / calls,
        "top_kernels_us": {k[:80]: v / calls / 1e3 for k, v in top},
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometry", choices=["esl", "demo"], default="demo")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--events", type=int, default=28 * 1024)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out-dir", default=None,
                    help="trace directory (default: the checkout's .cache/trace)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from eval.bench_geometry import rig_calibration, rig_frames
    from xmaps.models.depth_pipeline import XMapsDepthEngine
    from xmaps.ops.disparity import compute_event_disparity, rectify_events_packed
    from xmaps.ops.event_batch import EventBatch
    from xmaps.ops.frame_pipeline import depth_frame
    from xmaps.ops.scatter import scatter_disp_packed
    from xmaps.utils.cache import cache_dir, enable_compile_cache

    enable_compile_cache()
    out_dir = args.out_dir or cache_dir("trace")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"stage_trace needs a GPU, found {dev.platform}")

    calib = rig_calibration(args.geometry)
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=args.events, z_near=0.2, z_far=1.2,
        xmap_cache_dir=cache_dir("tables"),
    )
    cfg, tables = engine.cfg, engine.tables
    crop = cfg.tail_crop
    events = rig_frames(calib, args.frames, args.events)
    unsorted = [
        jax.device_put(EventBatch.from_structured(ev, args.events), dev)
        for ev in events
    ]
    sorted_ = [jax.device_put(engine.make_sorted_batch(ev), dev) for ev in events]

    @jax.jit
    def event_stage(batch):
        xr, yr = rectify_events_packed(batch.x, batch.y, tables.cam_map_packed)
        return compute_event_disparity(
            batch, tables.cam_mapx_i16, tables.cam_mapy_i16, tables.x_map,
            t_px_scale=cfg.t_px_scale, rect_coords=(xr, yr),
        )

    def scatter(res, prio, method):
        kw = {}
        if method == "runs":
            h = tables.x_map.shape[0]
            kw = dict(run_keys=(jnp.clip(res.y_rect, 0, h - 1), res.x_proj))
        return scatter_disp_packed(
            res.y_rect, res.x_rect + res.disp.astype(jnp.int32), res.disp,
            res.inlier, height=cfg.rect_height, width=cfg.rect_width,
            priority=prio, method=method, window=crop, **kw,
        )

    scatter_max = jax.jit(lambda res: scatter(res, None, "max"))
    scatter_runs = jax.jit(lambda res, prio: scatter(res, prio, "runs"))

    frame = jax.jit(
        lambda b, prio: depth_frame(
            b, tables, cfg, presort_priority=prio,
            presort_runs=True, display_only=True, display_packed=True,
        )
    )

    res_unsorted = [event_stage(b) for b in unsorted]
    res_sorted = [event_stage(b) for b, _ in sorted_]
    stages = {
        "event_stage": (event_stage, [(b,) for b in unsorted]),
        "scatter_max": (scatter_max, [(r,) for r in res_unsorted]),
        "scatter_runs": (
            scatter_runs, [(r, p) for r, (_, p) in zip(res_sorted, sorted_)]
        ),
        "frame": (frame, sorted_),
    }
    out = {
        "geometry": args.geometry,
        "device_kind": dev.device_kind,
        "events_per_frame": float(np.mean([len(ev) for ev in events])),
        "tail_crop": list(crop),
    }
    for name, (fn, arg_list) in stages.items():
        jax.block_until_ready([fn(*a) for a in arg_list])  # compile + warm
        tdir = os.path.join(out_dir, f"{args.geometry}_{name}")
        t0 = time.perf_counter()
        with jax.profiler.trace(tdir):
            for _ in range(args.reps):
                jax.block_until_ready([fn(*a) for a in arg_list])
        wall = time.perf_counter() - t0
        calls = args.reps * len(arg_list)
        out[name] = dict(device_time(tdir, calls), traced_wall_us=wall / calls * 1e6)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
