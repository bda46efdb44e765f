"""Stereo rectification (Bouguet), bit-exact vs cv2.stereoRectify.

The reference computes rectification once at init via cv2.stereoRectify with
alpha=-1 and default flags (cam_proj_calibration.py:202-217).  Default flags
include CALIB_ZERO_DISPARITY, and alpha<0 skips the free-scaling branch, so
the algorithm reduces to:

1. split the relative rotation in half between the two views,
2. rotate so the baseline becomes the horizontal (or vertical) axis,
3. choose a common focal length and averaged principal point from the
   reprojected image corners.

OpenCV stages the corner points through float32 buffers; we replicate that
quantization to achieve bit-exact P1/P2/Q (tests/test_calib_vs_opencv.py).
"""

from __future__ import annotations

import numpy as np

from xmaps.calib.geometry import rodrigues, undistort_points

__all__ = ["stereo_rectify"]


def stereo_rectify(
    K1: np.ndarray,
    D1: np.ndarray,
    K2: np.ndarray,
    D2: np.ndarray,
    image_size: tuple[int, int],
    R: np.ndarray,
    T: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compute rectification rotations and projections for a stereo pair.

    Semantics of cv2.stereoRectify(..., alpha=-1, flags=CALIB_ZERO_DISPARITY,
    newImageSize=imageSize), the exact configuration used by the reference.

    Args:
        K1, D1: intrinsics/distortion of the first view.
        K2, D2: intrinsics/distortion of the second view.
        image_size: (width, height) of the rectified output.
        R, T: rotation/translation taking view-1 coordinates to view-2.

    Returns:
        (R1, R2, P1, P2, Q).
    """
    K1 = np.asarray(K1, dtype=np.float64)
    K2 = np.asarray(K2, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64).reshape(3)
    nx, ny = image_size

    # Split the relative rotation evenly between both views.
    om = rodrigues(R) * -0.5
    r_r = rodrigues(om)
    t_half = r_r @ T

    # Rotate so the baseline is axis-aligned (idx 0: horizontal stereo).
    idx = 0 if abs(t_half[0]) > abs(t_half[1]) else 1
    c = t_half[idx]
    nt = float(np.linalg.norm(t_half))
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t_half, uu)
    nw = float(np.linalg.norm(ww))
    if nw > 0.0:
        ww *= float(np.arccos(abs(c) / nt)) / nw
    wR = rodrigues(ww)

    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    # Common focal length from the cross-axis focal lengths.
    ratio = 0.5  # newImageSize == imageSize
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio

    # Reproject the image corners to center the principal points.  OpenCV
    # stages these points through float32; replicate for bit parity.
    cc_new = np.zeros((2, 2))
    corners = np.array(
        [[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], dtype=np.float64
    )
    for k, (A, Dk, Rk) in enumerate(((K1, D1, R1), (K2, D2, R2))):
        und = undistort_points(
            corners.astype(np.float32).astype(np.float64), A, Dk
        ).astype(np.float32).astype(np.float64)
        ph = np.concatenate([und, np.ones((4, 1))], axis=1)
        ph = ph.astype(np.float32).astype(np.float64) @ Rk.T
        proj = (ph[:, :2] / ph[:, 2:3] * fc_new).astype(np.float32).astype(
            np.float64
        )
        avg = proj.mean(axis=0)
        cc_new[k] = [(nx - 1) / 2 - avg[0], (ny - 1) / 2 - avg[1]]

    # CALIB_ZERO_DISPARITY: identical principal points in both views.
    mean_cc = (cc_new[0] + cc_new[1]) * 0.5
    cc_new[0] = cc_new[1] = mean_cc

    cx1, cy1 = cc_new[0]
    cx2, cy2 = cc_new[1]

    P1 = np.array(
        [[fc_new, 0, cx1, 0], [0, fc_new, cy1, 0], [0, 0, 1, 0]],
        dtype=np.float64,
    )
    P2 = np.array(
        [[fc_new, 0, cx2, 0], [0, fc_new, cy2, 0], [0, 0, 1, 0]],
        dtype=np.float64,
    )
    P2[idx, 3] = t[idx] * fc_new

    Q = np.array(
        [
            [1, 0, 0, -cx1],
            [0, 1, 0, -cy1],
            [0, 0, 0, fc_new],
            [0, 0, -1.0 / t[idx], (cx1 - cx2) / t[idx]],
        ],
        dtype=np.float64,
    )
    return R1, R2, P1, P2, Q
