"""Synthetic scene/event generation for tests, benchmarks and demos.

Simulates the physical setup of the reference demonstrator: a laser
projector scanning column-by-column while an event camera observes the lit
scene.  For a given scene depth map (in the projector's view), every
projector pixel fires at its scan time and is reprojected into the camera,
producing a physically consistent event stream whose recovered depth is
known analytically -- the same role the ESL golden dataset plays for the
reference (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

from xmaps.calib.geometry import distort_points
from xmaps.calib.maps import (
    CalibrationParams,
    generate_linear_projector_time_map,
)

__all__ = [
    "make_synthetic_calibration",
    "simulate_plane_events",
    "simulate_sequence",
]


def make_synthetic_calibration(
    camera_width=64,
    camera_height=48,
    projector_width=90,
    projector_height=160,
    rectification_scale=2.75,
    baseline=0.12,
) -> CalibrationParams:
    """A small but realistic camera+projector rig for fast tests."""
    fc = camera_width * 0.9
    camera_K = np.array(
        [[fc, 0, camera_width / 2 - 0.7], [0, fc * 1.01, camera_height / 2 + 0.4], [0, 0, 1]]
    )
    camera_D = np.array([-0.12, 0.08, 0.001, -0.002, 0.0])
    fp = projector_width * 2.2
    projector_K = np.array(
        [[fp, 0, projector_width * 0.45], [0, fp, projector_height * 0.52], [0, 0, 1]]
    )
    # small rotation cam->proj
    ang = 0.05
    cam2proj_R = np.array(
        [
            [np.cos(ang), 0, np.sin(ang)],
            [0, 1, 0],
            [-np.sin(ang), 0, np.cos(ang)],
        ]
    )
    # Positive x-baseline so that P2[0,3] (= t[0] * fc_new) is positive and
    # disparities are non-negative, matching the reference rig convention
    # (data/ESL_calib_hhi.yaml gives P2[0,3] = +191.9).
    cam2proj_T = np.array([[baseline], [0.004], [0.008]])
    return CalibrationParams(
        camera_width=camera_width,
        camera_height=camera_height,
        projector_width=projector_width,
        projector_height=projector_height,
        rect_image_width=round(camera_width * rectification_scale),
        rect_image_height=round(camera_height * rectification_scale),
        camera_K=camera_K,
        camera_D=camera_D,
        projector_K=projector_K,
        projector_D=np.zeros(5),
        cam2proj_R=cam2proj_R,
        cam2proj_T=cam2proj_T,
    )


def simulate_plane_events(
    calib: CalibrationParams,
    depth_m: float = 0.6,
    frame_us: int = 16667,
    scan_upwards: bool = True,
    rng: np.random.Generator | None = None,
    jitter_us: float = 0.0,
    subsample: float = 1.0,
    scan_fraction: float = 1.0,
    t_offset_us: int = 0,
):
    """Simulate one frame of events from a scene surface.

    ``depth_m`` is either a scalar (fronto-parallel plane) or an
    (H_proj, W_proj) per-projector-pixel depth map (arbitrary scene).
    Each projector pixel (xp, yp) is back-projected to its scene depth
    (in projector coordinates), transformed into the camera frame,
    distorted and projected to a camera pixel; it fires at its linear
    scan time.  Returns a structured array sorted by t with fields x, y, p,
    t (int64 us), mirroring the Metavision EventCD layout.
    """
    rng = rng or np.random.default_rng(0)
    W_p, H_p = calib.projector_width, calib.projector_height
    tm = generate_linear_projector_time_map(W_p, H_p, scan_upwards)

    xs, ys = np.meshgrid(np.arange(W_p), np.arange(H_p))
    xs = xs.ravel()
    ys = ys.ravel()
    t_norm = tm[ys, xs]

    if subsample < 1.0:
        keep = rng.random(xs.shape[0]) < subsample
        xs, ys, t_norm = xs[keep], ys[keep], t_norm[keep]

    if np.ndim(depth_m) == 2:
        z = np.asarray(depth_m, np.float64)[ys, xs]
    else:
        z = np.full(xs.shape[0], float(depth_m))

    # Projector pixel -> ray -> 3D point on the scene (projector frame).
    Kp = calib.projector_K
    xn = (xs - Kp[0, 2]) / Kp[0, 0]
    yn = (ys - Kp[1, 2]) / Kp[1, 1]
    pts_proj = np.stack([xn * z, yn * z, z], axis=1)

    # Projector frame -> camera frame: X_proj = R X_cam + T, so
    # X_cam = R^T (X_proj - T).
    R = calib.cam2proj_R
    T = calib.cam2proj_T.reshape(3)
    pts_cam = (pts_proj - T) @ R

    # Camera projection with distortion.
    pn = pts_cam[:, :2] / pts_cam[:, 2:3]
    pd = distort_points(pn, calib.camera_D)
    Kc = calib.camera_K
    u = pd[:, 0] * Kc[0, 0] + Kc[0, 2]
    v = pd[:, 1] * Kc[1, 1] + Kc[1, 2]
    ui = np.rint(u).astype(np.int64)
    vi = np.rint(v).astype(np.int64)

    inb = (ui >= 0) & (ui < calib.camera_width) & (vi >= 0) & (vi < calib.camera_height)
    scan_us = frame_us * scan_fraction  # < 1.0 models vertical blanking
    t_us = (t_norm * scan_us).astype(np.float64)
    if jitter_us > 0:
        t_us = t_us + rng.normal(0, jitter_us, t_us.shape)
    # clip to the scan window so inter-frame spans never exceed the period,
    # and pin the scan-end event so pause-to-pause spans are exactly the
    # frame period (real scans end at a fixed phase of the vsync)
    t_us = np.clip(np.rint(t_us), 0, int(scan_us)).astype(np.int64)
    if len(t_us):
        t_us[np.argmax(t_us)] = int(scan_us)
    t_us = t_us + t_offset_us

    events = np.zeros(
        int(inb.sum()),
        dtype=[("x", "<u2"), ("y", "<u2"), ("p", "<i2"), ("t", "<i8")],
    )
    events["x"] = ui[inb]
    events["y"] = vi[inb]
    events["p"] = 1
    events["t"] = t_us[inb]
    order = np.argsort(events["t"], kind="stable")
    return events[order]


def simulate_sequence(
    calib: CalibrationParams,
    depths_m,
    fps: int = 60,
    scan_fraction: float = 0.85,
    subsample: float = 1.0,
    jitter_us: float = 2.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Simulate a multi-frame event stream at projector frame rate.

    One plane per frame (depths_m[k] for frame k), with vertical-blanking
    pauses between frames so the trigger finder can segment the stream
    (reference: trigger_finder.py:146-189 relies on inter-frame gaps).
    Returns a single time-sorted structured array.
    """
    rng = rng or np.random.default_rng(0)
    # floor: the frame span test is `span <= 1e6/fps` (trigger_finder.py:169)
    frame_us = int(1e6 / fps)
    frames = []
    for k, z in enumerate(depths_m):
        ev = simulate_plane_events(
            calib,
            depth_m=z if np.ndim(z) == 2 else float(z),
            frame_us=frame_us,
            rng=rng,
            jitter_us=jitter_us,
            subsample=subsample,
            scan_fraction=scan_fraction,
            t_offset_us=k * frame_us,
        )
        frames.append(ev)
    return np.concatenate(frames)
