"""Quantify the pseudo-ground-truth drift between this repo's ESL
implementation (apps/eval_esl.py) and the reference CPU implementation
(/root/reference/python/eval/compute_depth_esl.py, vendored from
uzh-rpg/ESL).

Refined ESL depth is the pseudo-ground-truth of the whole evaluation
table, so any implementation delta silently moves every Table-1 number.
The real ESL dataset is unreachable here (zero network egress -- see
EVAL_ESL.md), so the study runs both implementations on the SAME
synthetic scans at the full ESL geometry (640x480 camera, 1080x1920
projector, 3x rectification) and reports:

 1. per-pixel depth deltas at the disparity-init stage (full frame);
 2. per-pixel depth deltas after per-pixel refinement (on a crop --
    the reference refiner needs ~1 ms/pixel);
 3. the induced shift in Table-1 metrics: FR/RMSE of the SAME X-maps
    depth estimate evaluated against each implementation's refined
    output as GT.

The reference implementation is imported at runtime from
/root/reference (read-only) purely as a test oracle; nothing is copied.
Its final TV-denoise stage needs pylops, which is not installed, so the
comparison stops at the refinement stage for both sides (bilateral +
TV smoothing is a GT post-process shared by construction, reference
compute_depth_esl.py:242-247).

Usage:  python eval/gt_drift_study.py [--workdir DIR] [--small] [--json OUT]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REF_EVAL = "/root/reference/python/eval"


def write_esl_yaml(path, calib):
    """ESL FileStorage-dialect yaml (cam_K/cam_kc/proj_K/proj_kc/R/T)."""

    def mat(name, m):
        m = np.asarray(m, dtype=np.float64)
        data = ", ".join(repr(float(v)) for v in m.ravel())
        return (
            f"{name}: !!opencv-matrix\n"
            f"   rows: {m.shape[0]}\n"
            f"   cols: {m.shape[1] if m.ndim > 1 else 1}\n"
            f"   dt: d\n"
            f"   data: [ {data} ]\n"
        )

    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        f.write(mat("cam_K", calib.camera_K))
        f.write(mat("cam_kc", calib.camera_D.reshape(1, -1)))
        f.write(mat("proj_K", calib.projector_K))
        f.write(mat("proj_kc", calib.projector_D.reshape(1, -1)))
        f.write(mat("R", calib.cam2proj_R))
        f.write(mat("T", calib.cam2proj_T))


def reference_depth_init(scan_files, calib_yaml, proj_w, proj_h, cam_w, cam_h):
    """The reference eval flow (compute_depth_esl.py:179-224), driven with
    the same cv2 calls and constants; returns camera-view depth_init maps
    plus the pieces the refiner needs."""
    import cv2

    sys.path.insert(0, REF_EVAL)
    import compute_depth_esl as ref
    from esl_utilities import utils as ut

    rect_shape = (proj_w * 3, proj_h * 3)
    e3d = ut.loadCalibParams(calib_yaml, (rect_shape[0], rect_shape[1]), alpha=-1)
    disp_mapx, disp_mapy = ref.initUndistortRectifyMapInverse(
        e3d.cam_int, e3d.cam_dist, e3d.R0, e3d.P0, (cam_w, cam_h), None
    )
    img_mapx, img_mapy = cv2.initUndistortRectifyMap(
        e3d.cam_int, e3d.cam_dist, e3d.R0, e3d.P0,
        (rect_shape[0], rect_shape[1]), cv2.CV_32FC1,
    )
    proj_mapx, proj_mapy = cv2.initUndistortRectifyMap(
        e3d.proj_int, np.zeros((1, 5)), e3d.R1, e3d.P1,
        (rect_shape[0], rect_shape[1]), cv2.CV_32FC1,
    )
    proj_image = ref.get_projector_time_surface((proj_w, proj_h))
    proj_rect = cv2.remap(
        proj_image, proj_mapx, proj_mapy, cv2.INTER_NEAREST, cv2.BORDER_CONSTANT
    )

    outs = []
    for path in scan_files:
        cam_image = np.load(path)
        cam_image = (cam_image - np.min(cam_image[cam_image != 0])) / (
            np.max(cam_image[cam_image != 0]) - np.min(cam_image[cam_image != 0])
        )
        cam_image[cam_image < 0] = 0
        cam_rect = cv2.remap(
            cam_image, img_mapx, img_mapy, cv2.INTER_NEAREST, cv2.BORDER_CONSTANT
        )
        t0 = time.time()
        disparity = ref.disparity_init(cam_rect, proj_rect)
        init_s = time.time() - t0
        disparity = cv2.remap(
            disparity, disp_mapx, disp_mapy, cv2.INTER_NEAREST, cv2.BORDER_CONSTANT
        ).astype(np.float32)
        depth_init = ref.disparity_to_depth_rectified(
            disparity, e3d.P1, disp_mapx, disp_mapy
        )
        cam_for_refine = cam_image.copy()
        cam_for_refine[cam_for_refine == 0] = 1 / cam_for_refine[0, 0]
        outs.append(
            dict(depth_init=depth_init, cam=cam_for_refine, init_s=init_s)
        )
    return outs, dict(e3d=e3d, proj_image=proj_image, ref=ref)


def make_scenes(proj_w: int, proj_h: int) -> dict:
    """Synthetic scene depth maps in the projector view (H_p, W_p):
    fronto-parallel planes plus tilted / discontinuous / curved relief,
    widening the drift study beyond planes (real ESL scenes have all
    three characteristics)."""
    yy, xx = np.mgrid[0:proj_h, 0:proj_w]
    u = xx / max(proj_w - 1, 1)
    v = yy / max(proj_h - 1, 1)
    return {
        "plane_0.5": 0.5,
        "plane_0.8": 0.8,
        "tilted": 0.45 + 0.30 * u + 0.10 * v,
        "step": np.where(u < 0.5, 0.52, 0.78),
        "sinusoid": 0.65 + 0.06 * np.sin(2 * np.pi * 3 * u) * np.cos(2 * np.pi * 2 * v),
        "dome": 0.80
        - 0.22
        * np.sqrt(
            np.clip(1 - ((u - 0.5) / 0.45) ** 2 - ((v - 0.5) / 0.45) ** 2, 0, None)
        ),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/gt_drift")
    ap.add_argument("--small", action="store_true",
                    help="reduced geometry smoke mode")
    ap.add_argument("--json", default=None)
    ap.add_argument("--crop", type=int, default=56,
                    help="refinement crop side length [px]")
    ap.add_argument("--scenes", default="",
                    help="comma-separated scene subset (default: all)")
    args = ap.parse_args(argv)

    from xmaps.utils.cache import enable_compile_cache

    enable_compile_cache()
    from xmaps.apps import eval_esl, eval_xmaps
    from xmaps.utils.eval_metrics import evaluation_stats
    from xmaps.utils.synthetic import (
        make_synthetic_calibration,
        simulate_plane_events,
    )

    if args.small:
        cam_w, cam_h, proj_w, proj_h = 128, 96, 54, 96
        subsample = 1.0
    else:
        cam_w, cam_h, proj_w, proj_h = 640, 480, 1080, 1920
        subsample = 1.0

    os.makedirs(args.workdir, exist_ok=True)
    calib = make_synthetic_calibration(
        camera_width=cam_w, camera_height=cam_h,
        projector_width=proj_w, projector_height=proj_h,
    )
    yaml_path = os.path.join(args.workdir, "calib.yaml")
    write_esl_yaml(yaml_path, calib)

    scans_dir = os.path.join(args.workdir, "scans_np")
    os.makedirs(scans_dir, exist_ok=True)
    scenes = make_scenes(proj_w, proj_h)
    if args.scenes:
        keep = args.scenes.split(",")
        scenes = {k: scenes[k] for k in keep}
    scene_names = list(scenes)
    rng = np.random.default_rng(5)
    scan_files = []
    for i, (name, z) in enumerate(scenes.items()):
        ev = simulate_plane_events(
            calib, depth_m=z, scan_upwards=False, subsample=subsample, rng=rng
        )
        img = np.zeros((cam_h, cam_w), np.float64)
        img[ev["y"], ev["x"]] = (ev["t"] + 1) / (ev["t"].max() + 1)
        p = os.path.join(scans_dir, f"scan{i:03d}.npy")
        np.save(p, img)
        scan_files.append(p)

    common = [
        "-object_dir", args.workdir,
        "-proj_height", str(proj_h),
        "-proj_width", str(proj_w),
        "-calib", yaml_path,
        "-num_scans", str(len(scenes)),
        "-cam_width", str(cam_w),
        "-cam_height", str(cam_h),
    ]

    # ---- ours ---------------------------------------------------------
    t0 = time.time()
    assert eval_esl.main(common + ["-w", "3"]) == 0
    ours_s = time.time() - t0
    ours_init = [
        np.load(os.path.join(args.workdir, "esl", "depth_init", f"scans{i:03d}.npy"))
        for i in range(len(scenes))
    ]
    ours_opt = [
        np.load(os.path.join(args.workdir, "esl", "depth_optim", f"scans{i:03d}.npy"))
        for i in range(len(scenes))
    ]
    assert eval_xmaps.main(common + ["-no_pointcloud"]) == 0
    xmaps_depth = [
        np.load(os.path.join(args.workdir, "x_maps", "depth_init", f"scans{i:03d}.npy"))
        for i in range(len(scenes))
    ]

    # ---- reference oracle ----------------------------------------------
    t0 = time.time()
    ref_outs, ctx = reference_depth_init(
        scan_files, yaml_path, proj_w, proj_h, cam_w, cam_h
    )
    ref_init_s = time.time() - t0

    report = {"scans": [], "env": {
        "pylops_available": False,
        "note": "comparison stops at the refinement stage (reference TV "
        "denoise needs pylops, not installed); synthetic planes at full "
        "ESL geometry",
    }}

    c = args.crop
    for i, name in enumerate(scene_names):
        ref_i = ref_outs[i]["depth_init"]
        our_i = ours_init[i]
        both = (ref_i > 0) & (our_i > 0)
        d_init = np.abs(ref_i - our_i)[both]
        only_ref = int(((ref_i > 0) & (our_i == 0)).sum())
        only_ours = int(((our_i > 0) & (ref_i == 0)).sum())

        # refinement on a centered crop (reference refiner ~1 ms/px)
        ys, xs = np.where(both)
        cy, cx = int(np.median(ys)), int(np.median(xs))
        y0, x0 = max(cy - c // 2, 3), max(cx - c // 2, 3)
        crop = np.zeros_like(ref_i)
        crop[y0 : y0 + c, x0 : x0 + c] = ref_i[y0 : y0 + c, x0 : x0 + c]
        t0 = time.time()
        ref_opt = ctx["ref"].depth_optimization(
            crop, ref_outs[i]["cam"], ctx["proj_image"], 3, ctx["e3d"]
        )
        refine_s = time.time() - t0
        our_opt_crop = ours_opt[i][y0 : y0 + c, x0 : x0 + c]
        ref_opt_crop = ref_opt[y0 : y0 + c, x0 : x0 + c]
        bc = (ref_opt_crop > 0) & (our_opt_crop > 0)
        d_opt = np.abs(ref_opt_crop - our_opt_crop)[bc]

        # induced Table-1 shift: same X-maps estimate, two refined GTs.
        # confine to the crop where both refined GTs exist.
        xm = xmaps_depth[i][y0 : y0 + c, x0 : x0 + c]
        s_ref = evaluation_stats(xm, np.where(bc, ref_opt_crop, 0.0))
        s_our = evaluation_stats(xm, np.where(bc, our_opt_crop, 0.0))

        report["scans"].append({
            "scene": name,
            "init": {
                "both_valid_px": int(both.sum()),
                "only_ref_px": only_ref,
                "only_ours_px": only_ours,
                "abs_depth_delta_p50_mm": float(np.median(d_init) * 1e3),
                "abs_depth_delta_p99_mm": float(np.percentile(d_init, 99) * 1e3),
                "abs_depth_delta_max_mm": float(d_init.max() * 1e3),
                "ref_init_s": round(ref_outs[i]["init_s"], 2),
            },
            "refined_crop": {
                "crop_px": int(bc.sum()),
                "abs_depth_delta_p50_mm": float(np.median(d_opt) * 1e3),
                "abs_depth_delta_p99_mm": float(np.percentile(d_opt, 99) * 1e3),
                "abs_depth_delta_max_mm": float(d_opt.max() * 1e3),
                "ref_refine_s": round(refine_s, 2),
            },
            "induced_metric_shift": {
                "fillrate_ref_gt": round(s_ref.fillrate, 4),
                "fillrate_ours_gt": round(s_our.fillrate, 4),
                "fillrate_shift": round(abs(s_ref.fillrate - s_our.fillrate), 4),
                "rmse_ref_gt": round(s_ref.rmse, 4),
                "rmse_ours_gt": round(s_our.rmse, 4),
                "rmse_shift": round(abs(s_ref.rmse - s_our.rmse), 4),
            },
        })

    # FR/RMSE shift distribution over the scene set: how far the
    # reproduced Table-1 could drift from the paper's because our refined
    # GT differs from the reference's.
    fr = [s["induced_metric_shift"]["fillrate_shift"] for s in report["scans"]]
    rm = [s["induced_metric_shift"]["rmse_shift"] for s in report["scans"]]
    report["shift_distribution"] = {
        "scenes": scene_names,
        "fillrate_shift": {
            "p50": float(np.median(fr)),
            "max": float(np.max(fr)),
        },
        "rmse_shift": {
            "p50": float(np.median(rm)),
            "max": float(np.max(rm)),
        },
    }
    report["timing"] = {
        "ours_total_s": round(ours_s, 2),
        "ref_init_total_s": round(ref_init_s, 2),
    }
    out = json.dumps(report, indent=2)
    print(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
