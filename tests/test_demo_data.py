"""Demo-data generator end-to-end: YAML + EVT3 raw -> trigger finder ->
depth engine recovers the synthesized scene (the zero-hardware quick-start
path of the README)."""

import numpy as np

from xmaps.apps.make_demo_data import main as demo_main, shapes_depth_map
from xmaps.calib.maps import CalibrationParams
from xmaps.io.event_iterator import FileEventsIterator
from xmaps.models.depth_pipeline import XMapsDepthEngine
from xmaps.runtime.trigger_finder import RobustTriggerFinder
from xmaps.utils.stats import StatsPrinter


def test_demo_data_roundtrip(tmp_path):
    out = tmp_path / "demo"
    rc = demo_main(
        [
            "--out-dir", str(out),
            "--frames", "3",
            "--fps", "60",
            "--camera-width", "96",
            "--camera-height", "72",
            "--projector-width", "64",
            "--projector-height", "96",
            "--density", "1.0",
            "--scene", "shapes",
        ]
    )
    assert rc == 0
    assert (out / "calibration.yaml").exists()
    assert (out / "events.raw").exists()

    calib = CalibrationParams.from_yaml(
        str(out / "calibration.yaml"), 96, 72, 64, 96
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=8192, z_near=0.3, z_far=1.2
    )
    frames = []
    tf = RobustTriggerFinder(
        projector_fps=60,
        stats=StatsPrinter(silent=True),
        frame_callback=lambda e: frames.append(e.copy()),
    )
    for pkt in FileEventsIterator(str(out / "events.raw"), delta_t=1e6 / 240):
        tf.process_events(pkt)
    assert len(frames) >= 1

    res = engine.process_frame(frames[0])
    depth = np.asarray(res.depth)
    valid = depth > 0
    assert valid.mean() > 0.2
    # the scene depth range (shapes: ~0.5..1.05 m) must be recovered
    dmap = shapes_depth_map(64, 96, phase=0.0)
    assert abs(np.median(depth[valid]) - np.median(dmap)) < 0.1


def test_dump_frame_csv(tmp_path):
    """The per-frame debug CSV (engine.dump_frame_csv) lists every inlier
    with raw coords, rectified coords and disparity."""
    import csv

    from xmaps.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    calib = make_synthetic_calibration()
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=8192, z_near=0.2, z_far=1.2
    )
    events = simulate_plane_events(calib, depth_m=0.6, subsample=0.3)
    path = tmp_path / "frame.csv"
    n = engine.dump_frame_csv(events, str(path))
    assert n > 100

    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == n
    disp = np.array([float(r["disp"]) for r in rows])
    assert (disp >= 0).all()
    # rectified coordinates must be inside the rectified image
    yr = np.array([int(r["y_r"]) for r in rows])
    assert (yr >= 0).all() and (yr < calib.rect_image_height).all()
