"""Device-op tests against the NumPy oracle (reference formulas)."""

import numpy as np
import pytest

import jax.numpy as jnp

from xmaps.calib.maps import CamProjMaps
from xmaps.config import X_OFFSET
from xmaps.ops.disparity import compute_event_disparity
from xmaps.ops.event_batch import EventBatch
from xmaps.ops.image_tail import (
    depth_and_frame,
    dilate_max,
    disparity_luts,
    remap_nearest_i16,
    turbo_packed_lut,
    unpack_bgr,
)
from xmaps.ops.scatter import scatter_disp_last_wins
from xmaps.ops.xmap import build_x_map, build_x_map_numpy
from xmaps.utils.synthetic import make_synthetic_calibration, simulate_plane_events

import oracle


@pytest.fixture(scope="module")
def rig():
    calib = make_synthetic_calibration()
    maps = CamProjMaps(calib)
    tm_rect = maps.build_rectified_time_map(scan_upwards=True, border_replicate=True)
    x_map_np, _ = build_x_map_numpy(
        tm_rect,
        x_map_width=calib.projector_width,
        t_px_scale=calib.projector_width - 1,
        num_scanlines=calib.projector_width,
    )
    return calib, maps, tm_rect, x_map_np


def test_xmap_device_matches_numpy(rig):
    calib, maps, tm_rect, x_map_np = rig
    x_map_dev, t_diffs = build_x_map(
        jnp.asarray(tm_rect),
        x_map_width=calib.projector_width,
        t_px_scale=calib.projector_width - 1,
        num_scanlines=calib.projector_width,
    )
    x_map_dev = np.asarray(x_map_dev)
    # f32 vs f64 distance ties may flip a few argmins to a neighboring x.
    mismatch = x_map_dev != x_map_np
    frac = mismatch.mean()
    assert frac < 2e-3, f"x_map mismatch fraction {frac}"
    # mismatches, if any, must be near-ties
    if mismatch.any():
        assert np.abs(
            x_map_dev[mismatch].astype(np.int32) - x_map_np[mismatch].astype(np.int32)
        ).max() <= 2


def test_xmap_undefined_and_offset(rig):
    calib, maps, tm_rect, x_map_np = rig
    # column 0 (t == 0) is always undefined (reference x_map.py:34)
    assert np.all(x_map_np[:, 0] == 0)
    defined = x_map_np[x_map_np != 0]
    assert defined.min() >= X_OFFSET
    assert defined.max() < X_OFFSET + tm_rect.shape[1]


def test_disparity_matches_oracle(rig):
    calib, maps, tm_rect, x_map_np = rig
    events = simulate_plane_events(calib, depth_m=0.6)
    assert len(events) > 500

    xr_o, yr_o = oracle.oracle_rectify_i16(
        events, maps.disp_cam_mapx_i16, maps.disp_cam_mapy_i16
    )
    disp_o, inlier_o, t_scaled_o = oracle.oracle_disparity(
        xr_o, yr_o, events["t"], x_map_np, calib.projector_width - 1
    )

    cap = 16384
    batch = EventBatch.from_structured(events, cap)
    res = compute_event_disparity(
        batch,
        jnp.asarray(maps.disp_cam_mapx_i16),
        jnp.asarray(maps.disp_cam_mapy_i16),
        jnp.asarray(x_map_np),
        t_px_scale=calib.projector_width - 1,
    )
    n = len(events)
    np.testing.assert_array_equal(np.asarray(res.x_rect)[:n], xr_o.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(res.y_rect)[:n], yr_o.astype(np.int32))
    np.testing.assert_array_equal(np.asarray(res.inlier)[:n], inlier_o)
    assert not np.any(np.asarray(res.inlier)[n:])
    np.testing.assert_array_equal(
        np.asarray(res.disp)[:n][inlier_o], disp_o
    )


def test_disparity_inliers_physical(rig):
    """On a physically consistent scene most events must be inliers."""
    calib, maps, tm_rect, x_map_np = rig
    events = simulate_plane_events(calib, depth_m=0.6)
    batch = EventBatch.from_structured(events, 16384)
    res = compute_event_disparity(
        batch,
        jnp.asarray(maps.disp_cam_mapx_i16),
        jnp.asarray(maps.disp_cam_mapy_i16),
        jnp.asarray(x_map_np),
        t_px_scale=calib.projector_width - 1,
    )
    frac = np.asarray(res.inlier).sum() / len(events)
    assert frac > 0.7, f"inlier fraction {frac}"


def test_scatter_last_write_wins(rng):
    H, W = 37, 53
    n = 4000
    ys = rng.integers(0, H, n).astype(np.int32)
    xs = rng.integers(0, W, n).astype(np.int32)
    disp = rng.integers(0, 300, n).astype(np.float32)
    inlier = rng.random(n) < 0.8

    ref = np.zeros((H, W), dtype=np.float32)
    ref[ys[inlier], xs[inlier]] = disp[inlier]  # numpy: last write wins

    out = scatter_disp_last_wins(
        jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(disp), jnp.asarray(inlier),
        height=H, width=W,
    )
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_scatter_sorted_method_bit_identical(rng):
    """The sort-dedup unique-set strategy must equal scatter-max exactly,
    including priorities, padding, and out-of-bounds routing."""
    from xmaps.ops.scatter import scatter_disp_packed

    H, W = 37, 53
    n = 4096
    ys = rng.integers(-2, H + 2, n).astype(np.int32)
    xs = rng.integers(-2, W + 2, n).astype(np.int32)
    disp = rng.integers(0, 300, n).astype(np.float32)
    inlier = rng.random(n) < 0.8
    prio = rng.permutation(n).astype(np.int32)

    for kw in (
        dict(),
        dict(priority=jnp.asarray(prio)),
        dict(pad_shape=(48, 128)),
    ):
        a = scatter_disp_packed(
            jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(disp),
            jnp.asarray(inlier), height=H, width=W, method="max", **kw,
        )
        b = scatter_disp_packed(
            jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(disp),
            jnp.asarray(inlier), height=H, width=W, method="sorted", **kw,
        )
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_scatter_drops_out_of_bounds(rng):
    H, W = 16, 16
    ys = np.array([0, 5, -3, 20, 8], dtype=np.int32)
    xs = np.array([0, 5, 2, 2, 40], dtype=np.int32)
    disp = np.array([1, 2, 3, 4, 5], dtype=np.float32)
    inlier = np.ones(5, dtype=bool)
    out = np.asarray(
        scatter_disp_last_wins(
            jnp.asarray(ys), jnp.asarray(xs), jnp.asarray(disp), jnp.asarray(inlier),
            height=H, width=W,
        )
    )
    assert out[0, 0] == 1 and out[5, 5] == 2
    assert out.sum() == 3  # out-of-bounds writes dropped


def test_dilate_matches_oracle(rng):
    img = (rng.random((45, 67)) * 100).astype(np.float32)
    img[img < 70] = 0  # sparse
    out = np.asarray(dilate_max(jnp.asarray(img), 7))
    np.testing.assert_array_equal(out, oracle.oracle_dilate7(img))


def test_remap_matches_oracle(rng):
    img = (rng.random((40, 60)) * 50).astype(np.float32)
    mapx = rng.integers(-5, 70, (25, 30)).astype(np.int16)
    mapy = rng.integers(-5, 50, (25, 30)).astype(np.int16)
    out = np.asarray(remap_nearest_i16(jnp.asarray(img), jnp.asarray(mapx), jnp.asarray(mapy)))
    np.testing.assert_array_equal(out, oracle.oracle_remap_i16(img, mapx, mapy))


def test_depth_and_normalize_match_oracle(rng):
    """The per-disparity tables reproduce the reference's float32 depth,
    u8 normalisation and colour exactly, for every integer disparity the
    scatter can produce, looked up on the device."""
    from xmaps.ops.scatter import PACK
    from xmaps.utils.colormap import TURBO_BGR_U8

    p03 = 191.87
    luts = disparity_luts(p03, 0.4, 1.5)
    disp = np.arange(PACK, dtype=np.float32)
    depth_o = oracle.oracle_disp_to_depth(disp, p03)
    u8_o = oracle.oracle_clip_normalize_u8(depth_o, 0.4, 1.5)
    np.testing.assert_array_equal(luts.depth, depth_o)
    np.testing.assert_array_equal(luts.u8, u8_o)
    assert u8_o.max() == 255 and len(np.unique(u8_o)) > 200  # full range

    img = rng.integers(0, PACK, (30, 40)).astype(np.float32)
    img[img < 150] = 0
    depth_d, frame_d = depth_and_frame(jnp.asarray(img), luts)
    ii = img.astype(np.int64)
    np.testing.assert_array_equal(np.asarray(depth_d), depth_o[ii])
    np.testing.assert_array_equal(
        np.asarray(frame_d),
        oracle.oracle_colorize(u8_o[ii], np.asarray(TURBO_BGR_U8)),
    )


def test_colorize_matches_cv2(rng):
    cv2 = pytest.importorskip("cv2")
    u8 = rng.integers(0, 256, (20, 30)).astype(np.uint8)
    ours = np.asarray(unpack_bgr(jnp.asarray(turbo_packed_lut()[u8])))
    ref = cv2.applyColorMap(u8, cv2.COLORMAP_TURBO)
    ref[u8 == 0] = 255
    np.testing.assert_array_equal(ours, ref)
