"""One-time host-side calibration math (NumPy, OpenCV-compatible).

This package replaces the reference's OpenCV dependency on the hot-path host
(reference: cam_proj_calibration.py) with pure-NumPy implementations that are
bit-exact against OpenCV (validated in tests/test_calib_vs_opencv.py).  It
runs once at session start; all outputs are plain arrays that get uploaded to
device memory.
"""

from xmaps.calib.geometry import (  # noqa: F401
    rodrigues,
    distort_points,
    undistort_points,
    init_undistort_rectify_map,
    init_undistort_rectify_map_inverse,
)
from xmaps.calib.rectify import stereo_rectify  # noqa: F401
from xmaps.calib.cv_yaml import (  # noqa: F401
    load_cv_yaml,
    read_cv_matrix,
)
from xmaps.calib.maps import (  # noqa: F401
    CalibrationParams,
    CamProjMaps,
    map_f32_to_i16,
)
