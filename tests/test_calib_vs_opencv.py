"""Bit-exactness tests of the NumPy calibration stack against OpenCV.

OpenCV is available in this environment and serves purely as the golden
oracle; the framework itself never imports cv2.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from xmaps.calib import (
    CalibrationParams,
    CamProjMaps,
    init_undistort_rectify_map,
    init_undistort_rectify_map_inverse,
    rodrigues,
    stereo_rectify,
    undistort_points,
)
from xmaps.calib.maps import generate_linear_projector_time_map, remap_nearest


def _random_calib(rng):
    f1, f2 = rng.uniform(300, 2500, 2)
    K1 = np.array(
        [
            [f1, 0, rng.uniform(200, 800)],
            [0, f1 * rng.uniform(0.95, 1.05), rng.uniform(150, 900)],
            [0, 0, 1],
        ]
    )
    K2 = np.array(
        [
            [f2, 0, rng.uniform(200, 800)],
            [0, f2 * rng.uniform(0.95, 1.05), rng.uniform(150, 900)],
            [0, 0, 1],
        ]
    )
    D1 = rng.uniform(-0.2, 0.2, 5) * np.array([1, 0.5, 0.05, 0.05, 0.1])
    D2 = rng.uniform(-0.2, 0.2, 5) * np.array([1, 0.5, 0.05, 0.05, 0.1])
    R = cv2.Rodrigues(rng.uniform(-0.2, 0.2, 3))[0]
    T = rng.uniform(-0.5, 0.5, 3)
    T[0] += np.sign(T[0]) * 0.3
    return K1, D1, K2, D2, R, T.reshape(3, 1)


def test_rodrigues_roundtrip(rng):
    for _ in range(20):
        rvec = rng.uniform(-2, 2, 3)
        R_cv = cv2.Rodrigues(rvec)[0]
        np.testing.assert_allclose(rodrigues(rvec), R_cv, atol=1e-12)
        np.testing.assert_allclose(rodrigues(R_cv), rvec, atol=1e-9)


def test_undistort_points_bit_exact(rng):
    # Points inside the image domain: the 5-iteration fixed point converges
    # and must match cv2 exactly.  (Far outside the image the iteration can
    # diverge; behavior there is unspecified in both implementations.)
    for _ in range(5):
        K1, D1, *_ = _random_calib(rng)
        cx, cy = K1[0, 2], K1[1, 2]
        pts = rng.uniform(0, 1, (400, 2)) * np.array([2 * cx, 2 * cy])
        # keep normalized radius <= 1 (well beyond any real camera's field
        # of view); at extreme radii the fixed point can diverge and the
        # divergent garbage differs between implementations
        r = np.linalg.norm((pts - [cx, cy]) / [K1[0, 0], K1[1, 1]], axis=1)
        pts = pts[r <= 1.0]
        ours = undistort_points(pts, K1, D1)
        ref = cv2.undistortPoints(pts.reshape(-1, 1, 2), K1, D1).reshape(-1, 2)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)


def test_undistort_points_with_R_P(rng):
    K1, D1, K2, D2, R, T = _random_calib(rng)
    R1, R2, P1, P2, Q = stereo_rectify(K1, D1, K2, D2, (1600, 1200), R, T)
    pts = rng.uniform(0, 800, (100, 2))
    ours = undistort_points(pts, K1, D1, R=R1, P=P1)
    ref = cv2.undistortPoints(pts.reshape(-1, 1, 2), K1, D1, None, R1, P1).reshape(-1, 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9)


def test_stereo_rectify_bit_exact_synthetic(rng):
    for _ in range(8):
        K1, D1, K2, D2, R, T = _random_calib(rng)
        R1c, R2c, P1c, P2c, Qc, _, _ = cv2.stereoRectify(
            K1, D1, K2, D2, (1600, 1200), R, T, alpha=-1
        )
        R1, R2, P1, P2, Q = stereo_rectify(K1, D1, K2, D2, (1600, 1200), R, T)
        np.testing.assert_allclose(R1, R1c, rtol=0, atol=1e-14)
        np.testing.assert_allclose(R2, R2c, rtol=0, atol=1e-14)
        np.testing.assert_allclose(P1, P1c, rtol=0, atol=1e-9)
        np.testing.assert_allclose(P2, P2c, rtol=0, atol=1e-9)
        np.testing.assert_allclose(Q, Qc, rtol=0, atol=1e-9)


def test_stereo_rectify_bit_exact_hhi(hhi_yaml_path):
    calib = CalibrationParams.from_yaml(hhi_yaml_path, 640, 480, 1080, 1920)
    size = (calib.rect_image_width, calib.rect_image_height)
    R1c, R2c, P1c, P2c, Qc, _, _ = cv2.stereoRectify(
        calib.projector_K,
        calib.projector_D,
        calib.camera_K,
        calib.camera_D,
        size,
        calib.cam2proj_R,
        calib.cam2proj_T,
        alpha=-1,
    )
    maps = CamProjMaps(calib)
    np.testing.assert_allclose(maps.R1, R1c, rtol=0, atol=1e-14)
    np.testing.assert_allclose(maps.P2, P2c, rtol=0, atol=1e-9)
    np.testing.assert_allclose(maps.Q, Qc, rtol=0, atol=1e-9)


def test_forward_rectify_map_matches_cv(rng):
    K1, D1, K2, D2, R, T = _random_calib(rng)
    R1, R2, P1, P2, Q = stereo_rectify(K1, D1, K2, D2, (640, 480), R, T)
    mx, my = init_undistort_rectify_map(K1, D1, R1, P1, (640, 480))
    mxc, myc = cv2.initUndistortRectifyMap(K1, D1, R1, P1, (640, 480), cv2.CV_32FC1)
    np.testing.assert_allclose(mx, mxc, rtol=0, atol=2e-4)
    np.testing.assert_allclose(my, myc, rtol=0, atol=2e-4)


def test_inverse_rectify_map_matches_reference_formula(rng):
    """Inverse maps must match the reference's initUndistortRectifyMapInverse
    (cam_proj_calibration.py:31-41): cv2.undistortPoints over a meshgrid."""
    K1, D1, K2, D2, R, T = _random_calib(rng)
    R1, R2, P1, P2, Q = stereo_rectify(K1, D1, K2, D2, (640, 480), R, T)
    W, H = 320, 240
    mx, my = init_undistort_rectify_map_inverse(K1, D1, R1, P1, (W, H))
    coords = (
        np.stack(np.meshgrid(np.arange(W), np.arange(H)))
        .reshape((2, -1))
        .T.reshape((-1, 1, 2))
        .astype("float32")
    )
    pts = cv2.undistortPoints(coords, K1, D1, None, R1, P1).reshape((H, W, 2))
    np.testing.assert_allclose(mx, pts[..., 0], rtol=0, atol=2e-3)
    np.testing.assert_allclose(my, pts[..., 1], rtol=0, atol=2e-3)


def test_remap_nearest_matches_cv(rng):
    img = rng.random((64, 80)).astype(np.float32)
    mapx = (rng.random((33, 47)).astype(np.float32) * 90 - 5)
    mapy = (rng.random((33, 47)).astype(np.float32) * 74 - 5)
    for border, flag in ((True, cv2.BORDER_REPLICATE), (False, cv2.BORDER_CONSTANT)):
        ours = remap_nearest(img, mapx, mapy, border_replicate=border)
        ref = cv2.remap(img, mapx, mapy, cv2.INTER_NEAREST, borderMode=flag)
        np.testing.assert_array_equal(ours, ref)


def test_rectified_time_map_matches_cv_pipeline(hhi_yaml_path):
    """End-to-end init parity: rectified projector time map equals the
    reference recipe (proj_time_map.py:22-44) computed with cv2."""
    calib = CalibrationParams.from_yaml(hhi_yaml_path, 640, 480, 1080, 1920)
    maps = CamProjMaps(calib)
    ours = maps.build_rectified_time_map(scan_upwards=True, border_replicate=True)

    tm = generate_linear_projector_time_map(1080, 1920, True)
    mxc, myc = cv2.initUndistortRectifyMap(
        calib.projector_K,
        calib.projector_D,
        maps.R2,
        maps.P2,
        (calib.rect_image_width, calib.rect_image_height),
        cv2.CV_32FC1,
    )
    ref = cv2.remap(tm, mxc, myc, cv2.INTER_NEAREST, borderMode=cv2.BORDER_REPLICATE)
    # f32 LUT differences of ~1e-4 px flip a handful of pixels sitting on
    # rounding boundaries; require 99.99% exact pixels.
    mismatch = np.mean(ours != ref)
    assert mismatch < 1e-4, f"time map mismatch rate {mismatch}"


def test_yaml_dialects(hhi_yaml_path, nebra_yaml_path):
    c1 = CalibrationParams.from_yaml(hhi_yaml_path, 640, 480, 1080, 1920)
    assert c1.rect_image_width == round(640 * 2.75)
    assert c1.camera_K.shape == (3, 3)
    assert np.all(c1.projector_D == 0)

    c2 = CalibrationParams.from_yaml(nebra_yaml_path, 640, 480, 720, 1280)
    assert c2.camera_K[0, 0] > 0
    assert c2.cam2proj_R.shape == (3, 3)
