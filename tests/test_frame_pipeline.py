"""End-to-end frame pipeline tests: device program vs reference oracle."""

import numpy as np
import pytest


from xmaps.calib.maps import CamProjMaps
from xmaps.config import PipelineConfig
from xmaps.ops.event_batch import EventBatch
from xmaps.ops.frame_pipeline import DeviceTables, depth_frame, make_depth_frame_fn
from xmaps.ops.xmap import build_x_map_numpy
from xmaps.utils.synthetic import make_synthetic_calibration, simulate_plane_events

import oracle


@pytest.fixture(scope="module")
def rig():
    calib = make_synthetic_calibration()
    maps = CamProjMaps(calib)
    tm_rect = maps.build_rectified_time_map()
    x_map, _ = build_x_map_numpy(
        tm_rect,
        x_map_width=calib.projector_width,
        t_px_scale=calib.projector_width - 1,
        num_scanlines=calib.projector_width,
    )
    cfg = PipelineConfig(
        camera_width=calib.camera_width,
        camera_height=calib.camera_height,
        projector_width=calib.projector_width,
        projector_height=calib.projector_height,
        rect_width=calib.rect_image_width,
        rect_height=calib.rect_image_height,
        p03=float(maps.P2[0, 3]),
        event_capacity=16384,
        z_near=0.2,
        z_far=1.2,
    )
    tables = DeviceTables.from_maps(maps, x_map)
    return calib, maps, x_map, cfg, tables


def test_full_frame_bit_exact_vs_oracle(rig):
    calib, maps, x_map, cfg, tables = rig
    events = simulate_plane_events(calib, depth_m=0.55, jitter_us=3.0)
    batch = EventBatch.from_structured(events, cfg.event_capacity)

    out = depth_frame(batch, tables, cfg)

    ref = oracle.oracle_frame_projector_view(
        events,
        maps,
        x_map,
        t_px_scale=cfg.t_px_scale,
        z_near=cfg.z_near,
        z_far=cfg.z_far,
        H_proj=calib.projector_height,
        W_proj=calib.projector_width,
    )
    np.testing.assert_array_equal(np.asarray(out.disp_map), ref["disp_proj"])
    np.testing.assert_allclose(np.asarray(out.depth), ref["depth"], rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(out.frame_bgr), ref["bgr"])
    assert int(out.num_inliers) == int(ref["inlier"].sum())


def test_full_frame_camera_view_matches_oracle(rig):
    calib, maps, x_map, cfg, tables = rig
    cfg_cam = cfg.replace(camera_perspective=True)
    events = simulate_plane_events(calib, depth_m=0.55, jitter_us=3.0)
    batch = EventBatch.from_structured(events, cfg.event_capacity)

    out = depth_frame(batch, tables, cfg_cam)

    xr, yr = oracle.oracle_rectify_i16(
        events, maps.disp_cam_mapx_i16, maps.disp_cam_mapy_i16
    )
    disp, inlier, _ = oracle.oracle_disparity(
        xr, yr, events["t"], x_map, cfg.t_px_scale
    )
    ref_map = oracle.oracle_disp_map_camera_view(
        events, inlier, disp, calib.camera_height, calib.camera_width
    )
    np.testing.assert_array_equal(np.asarray(out.disp_map), ref_map)


def test_recovered_depth_physical(rig):
    """Depth recovered from simulated events must match the scene depth."""
    calib, maps, x_map, cfg, tables = rig
    for z_true in (0.4, 0.6, 0.9):
        events = simulate_plane_events(calib, depth_m=z_true)
        batch = EventBatch.from_structured(events, cfg.event_capacity)
        out = depth_frame(batch, tables, cfg)
        depth = np.asarray(out.depth)
        valid = depth > 0
        assert valid.mean() > 0.2, "depth map too sparse"
        med = np.median(depth[valid])
        # X-map time quantization limits precision; a small synthetic rig
        # has coarse disparity resolution (~1 px ~ 2-4 cm here)
        assert abs(med - z_true) < 0.05, f"median depth {med} vs {z_true}"


def _cropped(cfg, maps, calib):
    from xmaps.ops.image_tail import tail_crop_window

    return cfg.replace(
        tail_crop=tail_crop_window(
            maps.disp_proj_mapx_i16,
            maps.disp_proj_mapy_i16,
            calib.rect_image_height,
            calib.rect_image_width,
        )
    )


def test_full_frame_with_pallas_tail_matches_xla(rig):
    """The tail over the crop window (scatter, dilate and remap on the
    window the remap samples) must be bit-exact with the full-frame tail
    end to end."""
    calib, maps, x_map, cfg, tables = rig
    events = simulate_plane_events(calib, depth_m=0.55, jitter_us=3.0)
    batch = EventBatch.from_structured(events, cfg.event_capacity)
    ref = depth_frame(batch, tables, cfg)
    out = depth_frame(batch, tables, _cropped(cfg, maps, calib))
    np.testing.assert_array_equal(np.asarray(out.disp_map), np.asarray(ref.disp_map))
    np.testing.assert_array_equal(np.asarray(out.depth), np.asarray(ref.depth))
    np.testing.assert_array_equal(np.asarray(out.frame_bgr), np.asarray(ref.frame_bgr))


def test_jitted_fn_stable_across_frames(rig):
    calib, maps, x_map, cfg, tables = rig
    fn = make_depth_frame_fn(cfg)
    outs = []
    for z in (0.5, 0.7):
        events = simulate_plane_events(calib, depth_m=z)
        batch = EventBatch.from_structured(events, cfg.event_capacity)
        outs.append(fn(batch, tables))
    d0 = np.asarray(outs[0].depth)
    d1 = np.asarray(outs[1].depth)
    assert np.median(d0[d0 > 0]) < np.median(d1[d1 > 0])


def test_camera_view_with_pallas_colorize_matches_xla(rig):
    """The camera view ignores the projector tail's crop window: bit-exact
    with the uncropped camera path."""
    calib, maps, x_map, cfg, tables = rig
    cfg_cam = cfg.replace(camera_perspective=True)
    events = simulate_plane_events(calib, depth_m=0.55, jitter_us=3.0)
    batch = EventBatch.from_structured(events, cfg.event_capacity)
    ref = depth_frame(batch, tables, cfg_cam)
    out = depth_frame(batch, tables, _cropped(cfg_cam, maps, calib))
    np.testing.assert_array_equal(
        np.asarray(out.disp_map), np.asarray(ref.disp_map)
    )
    np.testing.assert_allclose(
        np.asarray(out.depth), np.asarray(ref.depth), rtol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(out.frame_bgr), np.asarray(ref.frame_bgr)
    )


def test_process_frames_group_matches_per_frame():
    """The group-dispatch API (multi-camera / offline batch) must match
    process_frame element-wise, across both staging modes."""
    from xmaps.models.depth_pipeline import XMapsDepthEngine

    calib = make_synthetic_calibration()
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=2048, z_near=0.2, z_far=1.2,
    )
    rng = np.random.default_rng(5)
    frames = [
        simulate_plane_events(
            calib, depth_m=0.4 + 0.1 * i, subsample=0.4, jitter_us=2.0,
            rng=rng,
        )
        for i in range(3)
    ]
    group = engine.process_frames(frames)
    assert len(group) == 3
    for ev, got in zip(frames, group):
        ref = engine.process_frame(ev)
        np.testing.assert_array_equal(
            np.asarray(got.depth), np.asarray(ref.depth)
        )
        np.testing.assert_array_equal(
            np.asarray(got.frame_bgr), np.asarray(ref.frame_bgr)
        )
        assert int(got.num_inliers) == int(ref.num_inliers)
    # group function is cached per (size, presort mode)
    assert len(engine._group_cache) == 1
    engine.process_frames(frames[:2])
    assert len(engine._group_cache) == 2


def test_display_only_matches_full(rig):
    """display_only must produce the identical colorized frame and inlier
    count with depth/disp_map absent, across both views, with and without
    the crop window."""
    calib, maps, x_map, cfg, tables = rig
    events = simulate_plane_events(calib, depth_m=0.6, jitter_us=2.0)
    batch = EventBatch.from_structured(events, cfg.event_capacity)
    for cam_view in (False, True):
        for c in (cfg, _cropped(cfg, maps, calib)):
            c = c.replace(camera_perspective=cam_view)
            full = depth_frame(batch, tables, c)
            slim = depth_frame(batch, tables, c, display_only=True)
            assert slim.depth is None and slim.disp_map is None
            np.testing.assert_array_equal(
                np.asarray(slim.frame_bgr), np.asarray(full.frame_bgr)
            )
            assert int(slim.num_inliers) == int(full.num_inliers)


def test_display_packed_matches_planes(rig):
    """display_packed must emit one (H, W) u32 packed-BGR plane whose
    host-side view equals the 3-channel display frame byte-for-byte,
    across both views, with and without the crop window."""
    calib, maps, x_map, cfg, tables = rig
    events = simulate_plane_events(calib, depth_m=0.6, jitter_us=2.0)
    batch = EventBatch.from_structured(events, cfg.event_capacity)
    for cam_view in (False, True):
        for c in (cfg, _cropped(cfg, maps, calib)):
            c = c.replace(camera_perspective=cam_view)
            ref = depth_frame(batch, tables, c, display_only=True)
            packed = depth_frame(
                batch, tables, c, display_only=True, display_packed=True
            )
            arr = np.asarray(packed.frame_bgr)
            assert arr.dtype == np.uint32 and arr.ndim == 2
            h, w = arr.shape
            unpacked = arr.view(np.uint8).reshape(h, w, 4)[..., :3]
            np.testing.assert_array_equal(
                unpacked, np.asarray(ref.frame_bgr)
            )
            assert int(packed.num_inliers) == int(ref.num_inliers)


def test_display_packed_requires_display_only(rig):
    calib, maps, x_map, cfg, tables = rig
    events = simulate_plane_events(calib, depth_m=0.6)
    batch = EventBatch.from_structured(events, cfg.event_capacity)
    with pytest.raises(ValueError, match="display_packed"):
        depth_frame(batch, tables, cfg, display_packed=True)
