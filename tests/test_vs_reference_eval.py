"""Differential tests against the ACTUAL reference EVAL code.

tests/test_vs_reference.py covers the live per-frame path against
/root/reference/python; this module does the same for the offline eval
baselines, importing /root/reference/python/eval directly:

- ESL-init disparity search (compute_depth_esl.py:72-85),
- the projector time surface (compute_depth_esl.py:94-102),
- the MC3D baseline end to end, including the reference's OWN
  loadCalibParams + initUndistortRectifyMapInverse map construction
  (mc3d_baseline.py:21-78, esl_utilities.py:124-151),
- the evaluation-table metrics (create_evaluation_table.py:14-62).

The ESL refiner is intentionally NOT asserted bit-equal: the reference
uses scipy's bounded Brent (compute_depth_esl.py:104-130) where this
framework uses a closed-form quadratic + grid search; the induced
pseudo-GT drift is quantified separately (eval/gt_drift_study.py,
eval/gt_drift_r04.json: FR shift 0.000, RMSE shift <= 1.4 mm).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

REF_EVAL = Path("/root/reference/python/eval")
pytestmark = pytest.mark.skipif(
    not REF_EVAL.exists(), reason="reference checkout not available"
)


@pytest.fixture(scope="module")
def ref():
    """Import the reference eval modules from /root/reference (read-only,
    used purely as a test oracle)."""
    sys.path.insert(0, str(REF_EVAL))
    try:
        import compute_depth_esl
        import mc3d_baseline
        from esl_utilities import utils as ut

        # create_evaluation_table's main() needs pandas at import time only
        import create_evaluation_table
    finally:
        sys.path.remove(str(REF_EVAL))
    return compute_depth_esl, mc3d_baseline, ut, create_evaluation_table


@pytest.fixture
def rng():
    return np.random.default_rng(11)


# ---------------------------------------------------------------------------
# ESL-init disparity search (compute_depth_esl.py:72-85)
# ---------------------------------------------------------------------------


def test_esl_disparity_init_vs_reference(ref, rng):
    """Random sparse rectified maps; the reference window is hardcoded to
    [5, 900), wider than the image, so every clamping branch runs."""
    compute_depth_esl, _, _, _ = ref
    from xmaps.apps.eval_esl import disparity_init_dense

    H, W = 24, 256
    cam = np.zeros((H, W), np.float32)
    proj = np.zeros((H, W), np.float32)
    cam_mask = rng.random((H, W)) < 0.15
    proj_mask = rng.random((H, W)) < 0.25
    cam[cam_mask] = rng.random(cam_mask.sum()).astype(np.float32) + 1e-3
    proj[proj_mask] = rng.random(proj_mask.sum()).astype(np.float32) + 1e-3

    want = compute_depth_esl.disparity_init(cam, proj)
    got = np.asarray(disparity_init_dense(cam, proj))
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_projector_time_surface_vs_reference(ref):
    compute_depth_esl, _, _, _ = ref
    from xmaps.calib.maps import generate_linear_projector_time_map

    Wp, Hp = 54, 96  # reference proj_shape convention is (W, H)
    want = compute_depth_esl.get_projector_time_surface((Wp, Hp))
    got = generate_linear_projector_time_map(Wp, Hp, scan_upwards=False)
    np.testing.assert_array_equal(got, want.astype(np.float32))


# ---------------------------------------------------------------------------
# MC3D baseline end to end, maps built by the reference's own code
# (esl_utilities.py:124-151 + mc3d_baseline.py:21-78)
# ---------------------------------------------------------------------------


def test_mc3d_vs_reference(ref, rng, tmp_path):
    _, mc3d, ut, _ = ref
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gt_drift_study",
        Path(__file__).resolve().parent.parent / "eval" / "gt_drift_study.py",
    )
    drift = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drift)

    from xmaps.apps.eval_mc3d import build_mc3d_tables, mc3d_disparity_dense
    from xmaps.utils.synthetic import make_synthetic_calibration

    # The reference builds the CAMERA inverse map on the PROJECTOR grid
    # (mc3d_baseline.py:111-113), so the projector grid must cover the
    # camera -- true at the real ESL geometry (1080x1920 vs 640x480)
    calib = make_synthetic_calibration(
        camera_width=40, camera_height=32, projector_width=45, projector_height=60
    )
    Wp, Hp = calib.projector_width, calib.projector_height
    cam_w, cam_h = calib.camera_width, calib.camera_height
    yaml_path = tmp_path / "calib.yaml"
    drift.write_esl_yaml(str(yaml_path), calib)

    # --- the reference's own flow (mc3d_baseline.main, :100-113) ---------
    proj_shape = (Wp, Hp)
    rect_shape = (Wp * 3, Hp * 3)
    e3d = ut.loadCalibParams(str(yaml_path), proj_shape, alpha=-1)
    proj_mapx, proj_mapy = mc3d.initUndistortRectifyMapInverse(
        e3d.proj_int, e3d.proj_dist, e3d.R1, e3d.P1, proj_shape, None
    )
    # NB the reference builds the CAMERA inverse map on the PROJECTOR grid
    # size (mc3d_baseline.py:111-113); map content is per-pixel, so the
    # camera-sized corner is identical -- asserted below.
    img_mapx, img_mapy = mc3d.initUndistortRectifyMapInverse(
        e3d.cam_int, e3d.cam_dist, e3d.R0, e3d.P0, proj_shape, None
    )

    cam = np.zeros((cam_h, cam_w), np.float32)
    mask = rng.random(cam.shape) < 0.3
    cam[mask] = rng.random(mask.sum()).astype(np.float32)

    want = mc3d.compute_disparity(
        cam, img_mapx, img_mapy, proj_mapx, proj_mapy, proj_shape, rect_shape
    )

    # --- ours -------------------------------------------------------------
    tables = build_mc3d_tables(calib, Wp, Hp, cam_w, cam_h)
    xc, yc, PX, PY, p03, _ = tables

    # map construction parity: our truncated tables == int() of the
    # reference's maps on the camera / projector grids
    np.testing.assert_array_equal(
        xc, img_mapx[:cam_h, :cam_w].astype(np.int32)
    )
    np.testing.assert_array_equal(
        yc, img_mapy[:cam_h, :cam_w].astype(np.int32)
    )
    np.testing.assert_array_equal(PX, proj_mapx[:Hp, :Wp].astype(np.int32))
    np.testing.assert_array_equal(PY, proj_mapy[:Hp, :Wp].astype(np.int32))
    np.testing.assert_array_equal(
        np.float32(p03), np.float32(e3d.P1[0, 3])
    )

    got = np.asarray(mc3d_disparity_dense(cam, tables, Wp, Hp, chunk=5))
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 20, "degenerate scene: too few correspondences"


# ---------------------------------------------------------------------------
# Evaluation-table metrics (create_evaluation_table.py:14-62)
# ---------------------------------------------------------------------------


def test_evaluation_stats_vs_reference(ref, rng, tmp_path):
    _, _, _, table = ref
    from xmaps.utils.eval_metrics import evaluation_stats, load_and_filter

    H, W = 37, 53
    gt = np.where(rng.random((H, W)) < 0.8, rng.uniform(0.2, 1.2, (H, W)), 0.0)
    est = np.where(
        rng.random((H, W)) < 0.7,
        gt + rng.normal(0, 0.02, (H, W)),
        rng.uniform(0, 1.5, (H, W)) * (rng.random((H, W)) < 0.5),
    )

    want = table.evaluation_stats(est, gt)
    got = evaluation_stats(est, gt)
    assert got.fillrate == want.fillrate
    assert got.rmse == want.rmse
    assert got.perc_1 == want.perc_1
    assert got.perc_5 == want.perc_5
    assert got.perc_10 == want.perc_10

    # the depth clipping / GT-masking loader (:57-62)
    depth = rng.uniform(0, 2.0, (H, W))
    p = tmp_path / "d.npy"
    np.save(p, depth)
    want_f = table.load_and_filter(str(p), gt, 0.3, 1.0)
    got_f = load_and_filter(depth.copy(), gt, 0.3, 1.0)
    np.testing.assert_array_equal(got_f, want_f)
