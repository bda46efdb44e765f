"""Geometry sweep for the projector-view tail: the crop window is driven
entirely by the rectification maps, so cropping must stay invisible
across rig shapes and rectification scales -- not just the two rigs the
other tests use.  Each case checks the crop-window chain against the
full-frame chain bit-for-bit on a full frame.
"""

import numpy as np
import pytest

from xmaps.models.depth_pipeline import XMapsDepthEngine
from xmaps.ops.frame_pipeline import depth_frame
from xmaps.utils.synthetic import (
    make_synthetic_calibration,
    simulate_plane_events,
)

CASES = [
    # (cam_w, cam_h, proj_w, proj_h, rect_scale)
    (64, 48, 90, 160, 2.75),    # demonstrator-like
    (64, 48, 90, 160, 1.5),     # same rig, tight rectification
    (80, 64, 64, 96, 2.0),      # wide camera, small projector
    (48, 64, 128, 96, 3.0),     # ESL-like 3x rectification, landscape proj
    (96, 32, 72, 200, 2.5),     # extreme aspect ratios
]


def _engine(cw, ch, pw, ph, scale):
    calib = make_synthetic_calibration(
        camera_width=cw, camera_height=ch,
        projector_width=pw, projector_height=ph,
        rectification_scale=scale,
    )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=2048, z_near=0.2, z_far=1.2,
    )
    return calib, engine


@pytest.mark.parametrize("cw,ch,pw,ph,scale", CASES)
def test_fused_tail_matches_xla_across_geometries(cw, ch, pw, ph, scale):
    calib, engine = _engine(cw, ch, pw, ph, scale)
    full_cfg = engine.cfg.replace(tail_crop=None)
    events = simulate_plane_events(
        calib, depth_m=0.55, subsample=0.5, jitter_us=2.0,
        rng=np.random.default_rng(cw * 7 + ph),
    )
    batch = engine.make_batch(events)
    ref = depth_frame(batch, engine.tables, full_cfg)
    assert int(ref.num_inliers) > 0
    got = depth_frame(batch, engine.tables, engine.cfg)
    np.testing.assert_array_equal(
        np.asarray(got.disp_map), np.asarray(ref.disp_map)
    )
    np.testing.assert_array_equal(np.asarray(got.depth), np.asarray(ref.depth))
    np.testing.assert_array_equal(
        np.asarray(got.frame_bgr), np.asarray(ref.frame_bgr)
    )
    assert int(got.num_inliers) == int(ref.num_inliers)


@pytest.mark.parametrize("cw,ch,pw,ph,scale", CASES)
def test_crop_window_covers_sampled_sources(cw, ch, pw, ph, scale):
    """Every in-frame remap source lies at least the dilation radius
    inside the crop window, unless the window meets the frame edge."""
    calib, engine = _engine(cw, ch, pw, ph, scale)
    r0, c0, h, w = engine.cfg.tail_crop
    H, W = calib.rect_image_height, calib.rect_image_width
    assert 0 <= r0 and r0 + h <= H and 0 <= c0 and c0 + w <= W
    X = engine.maps.disp_proj_mapx_i16.astype(np.int64)
    Y = engine.maps.disp_proj_mapy_i16.astype(np.int64)
    inb = (X >= 0) & (X < W) & (Y >= 0) & (Y < H)
    assert inb.any()
    ys, xs = Y[inb], X[inb]
    assert (ys - 3 >= r0).all() or r0 == 0
    assert (ys + 3 < r0 + h).all() or r0 + h == H
    assert (xs - 3 >= c0).all() or c0 == 0
    assert (xs + 3 < c0 + w).all() or c0 + w == W
    # the window is tight: it touches the extreme sources' halo
    assert r0 == max(int(ys.min()) - 3, 0)
    assert c0 + w == min(int(xs.max()) + 4, W)
