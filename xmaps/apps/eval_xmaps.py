"""Offline eval: ESL-style time-surface scans -> depth maps + point clouds.

Argument- and semantics-compatible with the reference offline eval
(eval/compute_depth_x_maps.py): loads per-scan .npy time-surface images,
treats nonzero pixels as events with t = normalized intensity, and runs the
camera-view depth pipeline with the ESL compatibility modes
(zero_undistort_proj_map=True, scan_upwards=False, BORDER_CONSTANT).

Adds --devices N to shard scans across devices (the single-program analog
of the reference's GNU-parallel fan-out, eval/x-map-eval.sh:49-66).
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np


def scan_image_to_events(cam_image: np.ndarray):
    """Nonzero time-surface pixels -> float-t events
    (reference: eval/compute_depth_x_maps.py:82-96)."""
    nz = cam_image != 0
    if not nz.any():
        return None
    vals = cam_image[nz]
    lo, hi = vals.min(), vals.max()
    img = (cam_image - lo) / (hi - lo)
    img[img < 0] = 0
    pos = np.argwhere(img > 0)
    return {
        "x": pos[:, 1].astype(np.int64),
        "y": pos[:, 0].astype(np.int64),
        "t": img[img > 0].astype(np.float32),
        "p": np.ones(len(pos), dtype=np.int64),
    }


def main(argv=None):
    from xmaps.utils.cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        description="Offline X-maps depth over ESL-style scan images "
        "(time-surface .npy per scan) on the JAX device; flag-compatible with the "
        "reference eval entry point",
        formatter_class=argparse.RawTextHelpFormatter,
    )
    parser.add_argument("-object_dir", type=str, default="", help="Directory containing scans_np/*.npy")
    parser.add_argument("-proj_height", type=int, default=1920)
    parser.add_argument("-proj_width", type=int, default=1080)
    parser.add_argument("-calib", type=str, default="", help="ESL calibration yaml")
    parser.add_argument("-num_scans", type=int, default=60)
    parser.add_argument("-start_scan", type=int, default=0)
    parser.add_argument("-cam_width", type=int, default=640)
    parser.add_argument("-cam_height", type=int, default=480)
    parser.add_argument("-no_pointcloud", action="store_true")
    parser.add_argument(
        "-devices",
        type=int,
        default=1,
        help="Shard scans across this many devices (0 = all available); the "
        "single-program analog of the reference's GNU-parallel fan-out",
    )
    args = parser.parse_args(argv)

    import jax

    from xmaps.calib.maps import CalibrationParams
    from xmaps.models.depth_pipeline import XMapsDepthEngine
    from xmaps.ops.event_batch import EventBatch
    from xmaps.utils.ply import write_ply
    from xmaps.utils.stats import SingleTimer

    x_maps_dir = os.path.join(args.object_dir, "x_maps")
    depth_dir = os.path.join(x_maps_dir, "depth_init")
    pc_dir = os.path.join(x_maps_dir, "pointcloud_init")
    os.makedirs(depth_dir, exist_ok=True)
    os.makedirs(pc_dir, exist_ok=True)

    scan_files = sorted(glob.glob(os.path.join(args.object_dir, "scans_np", "*.npy")))
    if not scan_files:
        print(f"No camera files found in {args.object_dir}/scans_np/!")
        return 1
    print(f"Found {len(scan_files)} scans!")

    calib = CalibrationParams.from_esl_yaml(
        args.calib,
        camera_width=args.cam_width,
        camera_height=args.cam_height,
        projector_width=args.proj_width,
        projector_height=args.proj_height,
    )

    with SingleTimer("Setting up ESL-mode engine"):
        engine = XMapsDepthEngine.from_calibration(
            calib,
            event_capacity=args.cam_width * args.cam_height,
            camera_perspective=True,
            scan_upwards=False,
            border_replicate=False,
            zero_undistort_proj_map=True,
        )

    scan_ids = [
        i
        for i in range(
            args.start_scan, min(args.start_scan + args.num_scans, len(scan_files))
        )
    ]

    n_dev = args.devices if args.devices > 0 else len(jax.devices())
    if n_dev > 1:
        # data-parallel fan-out over chips: groups of n_dev scans per
        # sharded dispatch (parallel.sharding; frames are independent)
        from xmaps.parallel import make_mesh, make_sharded_pipeline, shard_batches

        mesh = make_mesh(jax.devices()[:n_dev], data=n_dev, event=1)
        pipeline = make_sharded_pipeline(engine.cfg, engine.tables, mesh)
        group, group_ids = [], []

        def flush_group():
            if not group:
                return
            while len(group) < n_dev:  # pad the trailing group
                group.append(group[0])
            stacked = shard_batches(group[:n_dev], mesh, engine.cfg)
            t0 = time.time()
            out = pipeline(stacked)
            depths = np.asarray(jax.device_get(out.depth))
            print(
                f"Completed {len(group_ids)} scans on {n_dev} chips "
                f"in {time.time() - t0:.3f}s"
            )
            for k, i in enumerate(group_ids):
                np.save(
                    os.path.join(depth_dir, f"scans{str(i).zfill(3)}.npy"),
                    depths[k],
                )
            group.clear()
            group_ids.clear()

        for i in scan_ids:
            cam_image = np.load(scan_files[i])
            events = scan_image_to_events(cam_image)
            if events is None:
                print(f"Skip camera npy file {scan_files[i]} since it is empty")
                continue
            group.append(
                EventBatch.from_arrays(
                    events["x"], events["y"], events["t"], events["p"],
                    engine.cfg.event_capacity,
                )
            )
            group_ids.append(i)
            if len(group) == n_dev:
                flush_group()
        flush_group()
        if not args.no_pointcloud:
            print(
                "Note: point clouds are computed single-device; rerun with "
                "-devices 1 (or accept the serial pass below)."
            )
        else:
            return 0

    for i in scan_ids:
        cam_image = np.load(scan_files[i])
        events = scan_image_to_events(cam_image)
        if events is None:
            if n_dev == 1:
                print(f"Skip camera npy file {scan_files[i]} since it is empty")
            continue
        if n_dev == 1:
            print(f"Processing frame: {i}, camera npy file {scan_files[i]}")

        batch = EventBatch.from_arrays(
            events["x"], events["y"], events["t"], events["p"],
            engine.cfg.event_capacity,
        )
        if n_dev == 1:
            t0 = time.time()
            out = engine.process_batch_device(batch)
            depth = np.asarray(jax.device_get(out.depth))
            print(f"Completed disparity estimation: {i} in time {time.time() - t0}")
            np.save(os.path.join(depth_dir, f"scans{str(i).zfill(3)}.npy"), depth)

        if not args.no_pointcloud:
            # point cloud from rectified f32 coords of inliers
            # (reference compute_depth_x_maps.py:118-131)
            from xmaps.ops.disparity import compute_event_disparity
            import jax.numpy as jnp

            res = compute_event_disparity(
                batch,
                engine.tables.cam_mapx_i16,
                engine.tables.cam_mapy_i16,
                engine.tables.x_map,
                t_px_scale=engine.cfg.t_px_scale,
            )
            inlier = np.asarray(res.inlier)
            disp = np.asarray(res.disp)[inlier]
            xs = np.asarray(batch.x)[inlier]
            ys = np.asarray(batch.y)[inlier]
            xr_f32 = engine.maps.disp_cam_mapx_f32[ys, xs]
            yr_f32 = engine.maps.disp_cam_mapy_f32[ys, xs]
            pc = engine.maps.construct_point_cloud(xr_f32, yr_f32, disp)
            write_ply(os.path.join(pc_dir, f"scans{str(i).zfill(3)}.ply"), pc)

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
