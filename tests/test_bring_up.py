"""The parts that let the program run on a bare GPU host: the standalone
calibration YAML parser, the argparse CLI, the stdlib PNG sink, the
compile-cache placement, the engine's platform check, and the smoke
script's refusal to report without a GPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from xmaps.calib.cv_yaml import load_cv_yaml, parse_cv_yaml, read_cv_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_YAML = os.path.join(REPO, "data", "demo_rig", "demo_calibration.yaml")

XMAPS_DIALECT = """\
# X-maps dialect: explicit type-id mappings
camera_intrinsic_matrix:
  type-id: opencv_matrix
  rows: 3
  cols: 3
  dt: d
  data: [ 5.7600000000000000e+02, 0., 3.1930000000000001e+02, 0.,
      5.8176000000000005e+02, 2.4040000000000001e+02, 0., 0., 1. ]
relative_translation:
   type-id: opencv_matrix   # comment after a value
   rows: 3
   cols: 1
   dt: d
   data: [ -1.2e-01, 4.0e-03, .5 ]
image_size: [ 640, 480 ]
name: "a:b # not a comment"
flags:
  - 1
  - 2.5
  - abc
nested:
  inner: { a: 1, b: [2, 3] }
"""

ESL_DIALECT = """\
%YAML:1.0
---
cam_K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [ 1.6e+03, 0., 9.6e+02, 0., 1.6e+03, 5.4e+02, 0., 0., 1. ]
cam_kc: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [ -1.0e-01, 2.0e-02, 0., 0., 0. ]
"""


def test_yaml_xmaps_dialect():
    d = parse_cv_yaml(XMAPS_DIALECT)
    K = read_cv_matrix(d, "camera_intrinsic_matrix")
    assert K.shape == (3, 3) and K[0, 0] == 576.0 and K[1, 2] == 240.4
    np.testing.assert_array_equal(
        read_cv_matrix(d, "relative_translation").ravel(), [-0.12, 0.004, 0.5]
    )
    assert d["camera_intrinsic_matrix"]["dt"] == "d"
    assert d["image_size"] == [640, 480]
    assert d["name"] == "a:b # not a comment"
    assert d["flags"] == [1, 2.5, "abc"]
    assert d["nested"] == {"inner": {"a": 1, "b": [2, 3]}}


def test_yaml_opencv_filestorage_dialect():
    d = parse_cv_yaml(ESL_DIALECT)
    assert set(d) == {"cam_K", "cam_kc"}
    assert read_cv_matrix(d, "cam_K")[0, 2] == 960.0
    assert read_cv_matrix(d, "cam_kc").shape == (1, 5)
    with pytest.raises(ValueError, match="Could not read matrix"):
        read_cv_matrix(d, "proj_K")


def test_yaml_demo_calibration_matches_generator():
    """The shipped demo calibration loads and equals the synthetic rig
    make_demo_data writes."""
    from xmaps.calib.maps import CalibrationParams
    from xmaps.utils.synthetic import make_synthetic_calibration

    d = load_cv_yaml(DEMO_YAML)
    assert len(d) == 6
    got = CalibrationParams.from_yaml(DEMO_YAML, 640, 480, 720, 1280)
    want = make_synthetic_calibration(
        camera_width=640, camera_height=480,
        projector_width=720, projector_height=1280,
    )
    for f in ("camera_K", "camera_D", "projector_K", "cam2proj_R", "cam2proj_T"):
        np.testing.assert_allclose(
            np.ravel(getattr(got, f)), np.ravel(getattr(want, f)), rtol=1e-12,
            err_msg=f,
        )
    assert (got.rect_image_width, got.rect_image_height) == (1760, 1320)


@pytest.mark.parametrize(
    "text", ["a: [1, 2\n", "a: 1\n   b: 2\n", "just a line\n"]
)
def test_yaml_rejects_malformed(text):
    with pytest.raises(ValueError):
        parse_cv_yaml(text)


def test_cli_flags_and_defaults():
    from xmaps.apps.depth_reprojection import build_parser

    ap = build_parser()
    a = ap.parse_args(["--calib", DEMO_YAML])
    assert (a.projector_width, a.projector_height, a.projector_fps) == (720, 1280, 60)
    assert (a.z_near, a.z_far) == (0.1, 1.0)
    assert (a.camera_width, a.camera_height) == (640, 480)
    assert a.window == "none" and a.out_dir == "frames_out"
    assert not (a.loop_input or a.no_frame_dropping or a.camera_perspective
                or a.low_latency)
    assert a.input is a.capture is a.bias is a.profile_dir is None
    a = ap.parse_args([
        "--calib", DEMO_YAML, "--input", DEMO_YAML, "--window", "files",
        "--camera-perspective", "--no-frame-dropping", "--loop-input",
        "--low-latency", "--z-far", "1.5", "--projector-time-map", "tm.npy",
    ])
    assert a.window == "files" and a.camera_perspective and a.z_far == 1.5
    assert a.projector_time_map == "tm.npy"


@pytest.mark.parametrize(
    "argv",
    [
        [],  # --calib is required
        ["--calib", "/nonexistent/calib.yaml"],
        ["--calib", DEMO_YAML, "--window", "tk"],
        ["--calib", DEMO_YAML, "--input", "/nonexistent/events.raw"],
    ],
)
def test_cli_rejects_bad_arguments(argv):
    from xmaps.apps.depth_reprojection import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(argv)


def test_png_roundtrip(tmp_path, rng):
    from xmaps.utils.png import read_png, write_png

    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(read_png(path), img)


def test_file_sink_writes_rgb_png(tmp_path, rng):
    """The file sink writes every Nth BGR frame as an RGB PNG named by
    the frame index."""
    from xmaps.runtime.processor import FileSinkWindow
    from xmaps.utils.png import read_png

    sink = FileSinkWindow(str(tmp_path), every=2)
    frames = [rng.integers(0, 256, (8, 12, 3)).astype(np.uint8) for _ in range(4)]
    for i, f in enumerate(frames):
        if sink.wants_frame(i):
            sink.show_async(f)
    assert sorted(os.listdir(tmp_path)) == ["depth_000000.png", "depth_000002.png"]
    np.testing.assert_array_equal(
        read_png(str(tmp_path / "depth_000002.png")), frames[2][..., ::-1]
    )


def _cache_dir_in_child(env_value):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = (
        "import jax; from xmaps.utils.cache import enable_compile_cache; "
        "r = enable_compile_cache(); "
        "print(r); print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, check=True,
        capture_output=True, text=True, timeout=120,
    )
    return out.stdout.split()


def test_compile_cache_defaults_to_checkout():
    from xmaps.utils.cache import CACHE_ROOT

    ret, cfg = _cache_dir_in_child(None)
    assert ret == cfg == os.path.join(REPO, ".cache", "jax")
    assert CACHE_ROOT == os.path.join(REPO, ".cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".cache/" in f.read().split()


def test_compile_cache_honours_env(tmp_path):
    ret, cfg = _cache_dir_in_child(str(tmp_path))
    assert ret == cfg == str(tmp_path)  # JAX read the variable itself


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_check_platform_accepts(platform):
    from xmaps.models.depth_pipeline import check_platform

    check_platform(platform)


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_check_platform_refuses(platform):
    from xmaps.models.depth_pipeline import check_platform

    with pytest.raises(ValueError, match="unsupported platform"):
        check_platform(platform)


def test_chip_smoke_refuses_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass
