"""Smoke test of the depth pipeline on an NVIDIA GPU, checked against the
NumPy oracle (tests/oracle.py).

    python chip_smoke.py              # one card: the phases below
    python chip_smoke.py --devices 4  # four cards: only the sharded phases

One card:

- ``demo_cli``: the reference demonstrator rig (640x480 camera, 720x1280
  projector, rect 1760x1320) through the replay CLI
  (``xmaps.apps.depth_reprojection.main``: trigger finder -> staging ->
  ring/staged frame programs, PNG file sink) on a recording made by
  ``xmaps.apps.make_demo_data``.  Every frame the CLI computes is compared
  with the oracle on the events the trigger finder handed it, and every
  PNG written with the frame it shows.
- ``esl_projector`` / ``esl_camera``: the ESL evaluation rig (640x480
  camera, 1080x1920 projector, 3x rectification: 5760x3240 rect frame,
  5760x1080 X-map) at ~28k events/frame through
  ``XMapsDepthEngine.from_calibration`` -> ``process_frame`` and
  ``process_frames``, projector and camera views.

Four cards (``--devices 4``): ``process_frames_sharded`` over a 4-GPU
``data`` mesh and the ('data', 'event') = (2, 2) sharded pipeline, each
compared bit-equal with ``process_frame`` on one card.

Prints the card's name and power limit, one line per phase, and as its
last line ``{"ok": true, "device": {...}}``.  Exits non-zero without that
line when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def log(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def oracle_projector(events, maps, x_map, cfg):
    import oracle

    return oracle.oracle_frame_projector_view(
        events, maps, x_map, cfg.t_px_scale, cfg.z_near, cfg.z_far,
        cfg.projector_height, cfg.projector_width,
    )


def oracle_camera(events, maps, x_map, cfg):
    import oracle

    from xmaps.utils.colormap import TURBO_BGR_U8

    xr, yr = oracle.oracle_rectify_i16(
        events, maps.disp_cam_mapx_i16, maps.disp_cam_mapy_i16
    )
    disp, inlier, _ = oracle.oracle_disparity(
        xr, yr, events["t"], x_map, cfg.t_px_scale
    )
    disp_map = oracle.oracle_disp_map_camera_view(
        events, inlier, disp, cfg.camera_height, cfg.camera_width
    )
    depth = oracle.oracle_disp_to_depth(disp_map, maps.P2[0, 3])
    u8 = oracle.oracle_clip_normalize_u8(depth, cfg.z_near, cfg.z_far)
    bgr = oracle.oracle_colorize(u8, np.asarray(TURBO_BGR_U8))
    return {"disp_proj": disp_map, "depth": depth, "bgr": bgr, "inlier": inlier}


def check_frame(res, want, what: str, full: bool = True):
    """Bit-equality of one device FrameResult with the oracle's dict."""
    frame = np.asarray(res.frame_bgr)
    if frame.dtype == np.uint32:
        h, w = frame.shape
        frame = frame.view(np.uint8).reshape(h, w, 4)[..., :3]
    assert np.array_equal(frame, want["bgr"]), f"{what}: frame != oracle"
    assert int(res.num_inliers) == int(want["inlier"].sum()), (
        f"{what}: inliers {int(res.num_inliers)} != {int(want['inlier'].sum())}"
    )
    if full:
        assert np.array_equal(np.asarray(res.disp_map), want["disp_proj"]), (
            f"{what}: disparity != oracle"
        )
        assert np.array_equal(np.asarray(res.depth), want["depth"]), (
            f"{what}: depth != oracle"
        )


class FrameRecorder:
    """Records, for every frame the replay CLI dispatches, the events the
    trigger finder handed the pipe and the device result."""

    def __enter__(self):
        from xmaps.models.depth_pipeline import XMapsDepthEngine
        from xmaps.runtime.pipe import DepthReprojectionPipe

        self.events, self.results, self.engines = [], [], []
        self._saved = []

        def observe_events(cls, name):
            orig = getattr(cls, name)

            def wrapped(pipe, evs, *a):
                self.events.append(np.array(evs, copy=True))
                if pipe.engine not in self.engines:
                    self.engines.append(pipe.engine)
                return orig(pipe, evs, *a)

            self._saved.append((cls, name, orig))
            setattr(cls, name, wrapped)

        def observe_result(cls, name):
            orig = getattr(cls, name)

            def wrapped(engine, *a):
                out = orig(engine, *a)
                self.results.append(out)
                return out

            self._saved.append((cls, name, orig))
            setattr(cls, name, wrapped)

        observe_events(DepthReprojectionPipe, "process_ev_frame")
        observe_events(DepthReprojectionPipe, "process_ev_frame_indexed")
        observe_result(XMapsDepthEngine, "process_staged")
        observe_result(XMapsDepthEngine, "process_ring")
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self._saved:
            setattr(cls, name, orig)
        return False


def phase_demo_cli(workdir: str):
    from xmaps.apps import depth_reprojection, make_demo_data
    from xmaps.utils.png import read_png

    data_dir = os.path.join(workdir, "demo")
    make_demo_data.main(["--out-dir", data_dir, "--frames", "30"])
    out_dir = os.path.join(workdir, "demo_frames")
    argv = [
        "--calib", os.path.join(ROOT, "data", "demo_rig", "demo_calibration.yaml"),
        "--input", os.path.join(data_dir, "events.raw"),
        "--projector-width", "720", "--projector-height", "1280",
        "--z-near", "0.3", "--z-far", "1.2",
        "--no-frame-dropping", "--window", "files", "--out-dir", out_dir,
    ]
    t0 = time.perf_counter()
    with FrameRecorder() as rec:
        depth_reprojection.main(argv)
    wall = time.perf_counter() - t0
    assert len(rec.engines) == 1 and rec.results, "the CLI computed no frame"
    assert len(rec.events) == len(rec.results), (len(rec.events), len(rec.results))
    engine = rec.engines[0]
    x_map = engine.x_map_np  # the init artifact the frames are computed from

    t1 = time.perf_counter()
    inliers = []
    for k, (evs, res) in enumerate(zip(rec.events, rec.results)):
        want = oracle_projector(evs, engine.maps, x_map, engine.cfg)
        check_frame(res, want, f"demo frame {k}", full=False)
        inliers.append(int(res.num_inliers))
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    assert pngs, "the file sink wrote no PNG"
    for name in pngs:
        k = int(name[len("depth_"):-len(".png")])
        frame = np.asarray(rec.results[k].frame_bgr)
        h, w = frame.shape
        bgr = frame.view(np.uint8).reshape(h, w, 4)[..., :3]
        assert np.array_equal(read_png(os.path.join(out_dir, name)), bgr[..., ::-1])
    log(
        "demo_cli", frames=len(rec.results), pngs=len(pngs),
        mean_events=float(np.mean([len(e) for e in rec.events])),
        mean_inliers=float(np.mean(inliers)), oracle_equal=True,
        tail_crop=list(engine.cfg.tail_crop),
        cli_wall_s=wall, oracle_s=time.perf_counter() - t1,
        setup_s={k: v for k, v in engine.setup_timings},
    )


def esl_engine(camera_perspective: bool, capacity: int = 28 * 1024):
    from eval.bench_geometry import rig_calibration
    from xmaps.models.depth_pipeline import XMapsDepthEngine
    from xmaps.utils.cache import cache_dir

    calib = rig_calibration("esl")
    t0 = time.perf_counter()
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=capacity, z_near=0.2, z_far=1.2,
        camera_perspective=camera_perspective,
        xmap_cache_dir=cache_dir("tables"),
    )
    return calib, engine, time.perf_counter() - t0


def phase_esl(camera_perspective: bool, n_frames: int = 3):
    import jax

    from eval.bench_geometry import rig_frames

    calib, engine, setup_s = esl_engine(camera_perspective)
    x_map = engine.x_map_np
    frames = rig_frames(calib, n_frames, engine.cfg.event_capacity)

    t0 = time.perf_counter()
    single = [jax.block_until_ready(engine.process_frame(frames[0]))]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single += [jax.block_until_ready(engine.process_frame(ev)) for ev in frames[1:]]
    run_s = (time.perf_counter() - t0) / max(len(frames) - 1, 1)
    t0 = time.perf_counter()
    group = jax.block_until_ready(engine.process_frames(frames))
    group_first_s = time.perf_counter() - t0

    oracle_fn = oracle_camera if camera_perspective else oracle_projector
    t0 = time.perf_counter()
    for k, ev in enumerate(frames):
        want = oracle_fn(ev, engine.maps, x_map, engine.cfg)
        check_frame(single[k], want, f"esl frame {k} process_frame")
        check_frame(group[k], want, f"esl frame {k} process_frames")
    log(
        "esl_camera" if camera_perspective else "esl_projector",
        frames=len(frames), mean_events=float(np.mean([len(e) for e in frames])),
        inliers=[int(r.num_inliers) for r in single], oracle_equal=True,
        rect=[engine.cfg.rect_height, engine.cfg.rect_width],
        xmap=list(x_map.shape), tail_crop=list(engine.cfg.tail_crop),
        setup_s=setup_s, first_frame_s=first_s, frame_s=run_s,
        group_first_s=group_first_s, oracle_s=time.perf_counter() - t0,
    )


def phase_sharded(n: int):
    import jax

    from eval.bench_geometry import rig_frames
    from xmaps.ops.event_batch import EventBatch
    from xmaps.parallel import make_mesh, make_sharded_pipeline, shard_batches

    devices = jax.devices()[:n]
    assert len(devices) == n, f"need {n} GPUs, found {len(jax.devices())}"
    calib, engine, setup_s = esl_engine(False)
    frames = rig_frames(calib, 2 * n, engine.cfg.event_capacity)
    refs = [jax.block_until_ready(engine.process_frame(ev)) for ev in frames]

    t0 = time.perf_counter()
    mesh = make_mesh(devices, data=n, event=1)
    outs = jax.block_until_ready(engine.process_frames_sharded(frames, mesh))
    dp_s = time.perf_counter() - t0
    for k, (got, ref) in enumerate(zip(outs, refs)):
        for field in ("frame_bgr", "depth", "disp_map", "num_inliers"):
            assert np.array_equal(
                np.asarray(getattr(got, field)), np.asarray(getattr(ref, field))
            ), f"data-parallel frame {k}: {field} != process_frame"
    log("sharded_data", devices=n, frames=len(frames), equal=True,
        setup_s=setup_s, first_call_s=dp_s)

    mesh = make_mesh(devices, data=2, event=n // 2)
    t0 = time.perf_counter()
    pipeline = make_sharded_pipeline(engine.cfg, engine.tables, mesh)
    stacked = shard_batches(
        [EventBatch.from_structured(ev, engine.cfg.event_capacity) for ev in frames[:4]],
        mesh, engine.cfg,
    )
    out = jax.block_until_ready(pipeline(stacked))
    ev_s = time.perf_counter() - t0
    for k in range(4):
        for field in ("frame_bgr", "depth", "disp_map", "num_inliers"):
            assert np.array_equal(
                np.asarray(getattr(out, field))[k],
                np.asarray(getattr(refs[k], field)),
            ), f"(2, {n // 2}) mesh frame {k}: {field} != process_frame"
    log("sharded_data_event", mesh=[2, n // 2], frames=4, equal=True,
        first_call_s=ev_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=[1, 4], default=1)
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform})", file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"chip_smoke: {args.devices} GPUs wanted, {len(devs)} found", file=sys.stderr)
        return 2
    print(gpu_name_and_power(), flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}", flush=True)

    from xmaps.utils.cache import enable_compile_cache

    log("compile_cache", dir=enable_compile_cache())
    if args.devices == 4:
        phase_sharded(4)
    else:
        with tempfile.TemporaryDirectory() as workdir:
            phase_demo_cli(workdir)
        phase_esl(camera_perspective=False)
        phase_esl(camera_perspective=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
