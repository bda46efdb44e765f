"""MC3D baseline for the offline evaluation, on device.

Re-implements the reference's vendored MC3D per-pixel temporal
correspondence baseline (eval/mc3d_baseline.py:40-78, from uzh-rpg/ESL) as
a dense JAX program.

Reference semantics, per nonzero camera pixel (i, j) of a median-blurred
time-surface scan:

1. (xc, yc) = trunc(inverse camera rectification map[i, j])   (:29-37)
2. proj_id = trunc(Wp * Hp * t);  proj_x = proj_id // Hp,
   proj_y = proj_id % Hp  (column-major unravel, :58-59)
3. search y in [proj_y - nc, proj_y + nc), nc = Hp // 15, for the
   candidate minimizing |yc - trunc(proj_inverse_map_y[y, proj_x])|; if
   the minimum is <= 50 rows and the disparity
   trunc(proj_inverse_map_x[y, proj_x]) - xc is positive, keep it (:60-75)

The inner search is restructured as a dense windowed argmin: a
``lax.fori_loop`` sweeps the window in row chunks, gathering
PY[y, proj_x] for every camera pixel at once and carrying the running
(min |yc - PY|, argmin y) with strict-less updates -- ascending scan
order reproduces np.argmin's FIRST-minimum tie semantics bit-for-bit
(:60-75), so the result is EXACT, not the earlier clamped-global-inverse
approximation (which matched only where |yc - PY| was unimodal in the
window).  The same <= 50 and disparity > 0 acceptance tests follow.

Depth = P[0,3] / disparity with zero-preserve (:15-17), saved to
mc3d/depth/scansNNN.npy for the evaluation table.
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import time

import numpy as np

DIFF_Y_MAX = 50  # reference eval/mc3d_baseline.py:71


def build_mc3d_tables(calib, proj_w: int, proj_h: int, cam_w: int, cam_h: int):
    """Host-precomputed static tables (the reference's map setup, :108-113).

    Returns (xc, yc, PX, PY, p03, rect_size): truncated inverse rect maps
    for the camera grid, truncated inverse rect maps for the projector
    grid, and the depth scale.
    """
    from xmaps.calib.geometry import (
        init_undistort_rectify_map_inverse,
    )
    from xmaps.calib.rectify import stereo_rectify

    rect_size = (proj_w, proj_h)  # loadCalibParams(calib, proj_shape)
    R1, R2, P1, P2, Q = stereo_rectify(
        calib.projector_K,
        calib.projector_D,
        calib.camera_K,
        calib.camera_D,
        rect_size,
        calib.cam2proj_R,
        calib.cam2proj_T,
    )
    # camera: R1/P1 (first stereoRectify outputs -- reference e3d.R0/P0)
    cam_mx, cam_my = init_undistort_rectify_map_inverse(
        calib.camera_K, calib.camera_D, R1, P1, (cam_w, cam_h)
    )
    # projector: R2/P2 (reference e3d.R1/P1), WITH projector distortion
    proj_mx, proj_my = init_undistort_rectify_map_inverse(
        calib.projector_K, calib.projector_D, R2, P2, (proj_w, proj_h)
    )
    xc = cam_mx.astype(np.int32)  # int() truncation (reference :33-34)
    yc = cam_my.astype(np.int32)
    PX = proj_mx.astype(np.int32)  # (Hp, Wp)
    PY = proj_my.astype(np.int32)
    return xc, yc, PX, PY, float(P2[0, 3]), rect_size


def mc3d_disparity_dense(
    cam_image, tables, proj_w: int, proj_h: int, chunk: int = 16
):
    """Dense MC3D correspondence (reference compute_disparity, :40-78).

    Bit-exact to the reference's per-pixel window scan: a fori_loop sweeps
    the 2*nc window in ``chunk``-row slabs, gathering PY for every pixel
    at once; strict-less carry updates + in-chunk argmin (both
    first-occurrence) reproduce np.argmin's tie semantics exactly.
    """
    import jax
    import jax.numpy as jnp

    xc_np, yc_np, PX_np, PY_np, p03, rect_size = tables
    rect_w3, rect_h3 = proj_w * 3, proj_h * 3  # reference rectified_shape
    nc = proj_h // 15

    cam = jnp.asarray(cam_image, jnp.float32)
    xc = jnp.asarray(xc_np)
    yc = jnp.asarray(yc_np)
    PXf = jnp.asarray(PX_np.reshape(-1))
    PYf = jnp.asarray(PY_np.reshape(-1))

    valid = cam > 0
    # reference :52-57: strict in-bounds of the rectified event coords
    valid &= (xc > 0) & (xc < rect_w3) & (yc > 0) & (yc < rect_h3)

    pid = (proj_w * proj_h * cam).astype(jnp.int32)
    in_id = (pid >= 0) & (pid < proj_w * proj_h)  # unravel try/except (:73)
    pid_c = jnp.clip(pid, 0, proj_w * proj_h - 1)
    proj_x = pid_c // proj_h
    proj_y = pid_c % proj_h
    valid &= in_id

    # windowed argmin of |yc - PY[y, proj_x]| over
    # y in [max(proj_y - nc, 0), min(proj_y + nc, proj_h))  (:60-71)
    BIG = jnp.int32(1 << 30)
    n_steps = -(-2 * nc // chunk)
    ks = jnp.arange(chunk, dtype=jnp.int32)

    def body(s, carry):
        best_diff, best_y = carry
        # candidate rows for this slab, ascending: (chunk, H, W)
        k = s * chunk + ks
        y_k = proj_y[None] + (k - nc)[:, None, None]
        # k < 2*nc: the last slab may be partial and must not scan past
        # the reference's window upper bound min(proj_y + nc, proj_h)
        ok_k = (y_k >= 0) & (y_k < proj_h) & (k < 2 * nc)[:, None, None]
        lin = jnp.clip(y_k, 0, proj_h - 1) * proj_w + proj_x[None]
        d = jnp.where(ok_k, jnp.abs(yc[None] - PYf[lin]), BIG)
        # first minimum within the slab (jnp.argmin picks the first)...
        arg = jnp.argmin(d, axis=0)
        d_min = jnp.take_along_axis(d, arg[None], axis=0)[0]
        y_min = jnp.take_along_axis(y_k, arg[None], axis=0)[0]
        # ...and strict-less across slabs keeps the earliest overall
        upd = d_min < best_diff
        return (
            jnp.where(upd, d_min, best_diff),
            jnp.where(upd, y_min, best_y),
        )

    best_diff, best_y = jax.lax.fori_loop(
        0,
        n_steps,
        body,
        (jnp.full(cam.shape, BIG, jnp.int32), jnp.zeros(cam.shape, jnp.int32)),
    )

    px = PXf[jnp.clip(best_y, 0, proj_h - 1) * proj_w + proj_x]
    disp = px - xc
    ok = valid & (best_diff <= DIFF_Y_MAX) & (disp > 0)
    return jnp.where(ok, disp, 0).astype(jnp.float32)


def main(argv=None):
    from xmaps.utils.cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        description="MC3D temporal-correspondence baseline: per-scan depth "
        "maps for a camera+projector rig (JAX reimplementation)"
    )
    parser.add_argument("-object_dir", type=str, default="")
    parser.add_argument("-proj_height", type=int, default=1920)
    parser.add_argument("-proj_width", type=int, default=1080)
    parser.add_argument("-calib", type=str, default="")
    parser.add_argument("-num_scans", type=int, default=60)
    parser.add_argument("-start_scan", type=int, default=0)
    parser.add_argument("-cam_width", type=int, default=640)
    parser.add_argument("-cam_height", type=int, default=480)
    args = parser.parse_args(argv)

    import jax

    from xmaps.calib.maps import CalibrationParams
    from xmaps.utils.denoise import median_blur_3x3

    calib = CalibrationParams.from_esl_yaml(
        args.calib,
        camera_width=args.cam_width,
        camera_height=args.cam_height,
        projector_width=args.proj_width,
        projector_height=args.proj_height,
    )

    depth_dir = os.path.join(args.object_dir, "mc3d", "depth")
    os.makedirs(depth_dir, exist_ok=True)

    scan_files = sorted(glob.glob(os.path.join(args.object_dir, "scans_np", "*.npy")))
    if not scan_files:
        print("No camera files found!")
        return 1
    print(f"Found {len(scan_files)} scans!")

    tables = build_mc3d_tables(
        calib, args.proj_width, args.proj_height, args.cam_width, args.cam_height
    )
    p03 = tables[4]

    for k in range(args.start_scan, min(args.start_scan + args.num_scans, len(scan_files))):
        cam_image = np.load(scan_files[k])
        if np.count_nonzero(cam_image) == 0:
            print(f"Skip {k}")
            continue
        print(scan_files[k])
        t0 = time.time()
        blurred = np.asarray(
            jax.device_get(median_blur_3x3(cam_image.astype(np.float32)))
        )
        disparity = np.asarray(
            jax.device_get(
                mc3d_disparity_dense(
                    blurred, tables, args.proj_width, args.proj_height
                )
            )
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            depth = np.where(disparity != 0, p03 / disparity, 0.0).astype(np.float32)
        print(f"Completed frame {k} in time {time.time() - t0}")
        np.save(os.path.join(depth_dir, f"scans{str(k).zfill(3)}.npy"), depth)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
