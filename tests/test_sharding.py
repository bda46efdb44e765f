"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The sharded pipeline must be bit-identical to the single-device program:
the packed scatter-max is associative and event indices are global, so
event-parallel execution preserves NumPy last-write-wins semantics.
"""

import numpy as np
import pytest

import jax

from xmaps.calib.maps import CamProjMaps
from xmaps.config import PipelineConfig
from xmaps.ops.event_batch import EventBatch
from xmaps.ops.frame_pipeline import DeviceTables, depth_frame
from xmaps.ops.xmap import build_x_map_numpy
from xmaps.parallel import make_mesh, make_sharded_pipeline, shard_batches
from xmaps.utils.synthetic import make_synthetic_calibration, simulate_plane_events


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
    return calib, cfg, tables


@pytest.mark.parametrize("data,event", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_matches_single_chip(rig, data, event):
    calib, cfg, tables = rig
    if len(jax.devices()) < data * event:
        pytest.skip("needs 8 devices")

    depths = [0.45, 0.55, 0.65, 0.75, 0.5, 0.6, 0.7, 0.8]
    batches = [
        EventBatch.from_structured(
            simulate_plane_events(calib, depth_m=z, jitter_us=2.0),
            cfg.event_capacity,
        )
        for z in depths
    ]

    mesh = make_mesh(jax.devices()[: data * event], data=data, event=event)
    pipeline = make_sharded_pipeline(cfg, tables, mesh)
    stacked = shard_batches(batches, mesh, cfg)
    out = pipeline(stacked)

    for i, b in enumerate(batches):
        ref = depth_frame(b, tables, cfg)
        np.testing.assert_array_equal(
            np.asarray(out.disp_map)[i], np.asarray(ref.disp_map)
        )
        np.testing.assert_array_equal(
            np.asarray(out.frame_bgr)[i], np.asarray(ref.frame_bgr)
        )
        assert int(out.num_inliers[i]) == int(ref.num_inliers)


@pytest.mark.parametrize(
    "name", ["first_per_yt", "first_per_xy", "last_per_xy",
             "mean_first_last_per_xy"]
)
def test_sharded_frame_filter_matches_single_chip(rig, name):
    """Event-sharded meshes must apply the configured dedup filter with
    global winners/ranks (all_gather + replicated filter), staying
    bit-identical to the single-chip depth_frame."""
    calib, cfg, tables = rig
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import dataclasses
    cfg = dataclasses.replace(cfg, frame_filter=name)

    depths = [0.5, 0.7]
    batches = [
        EventBatch.from_structured(
            simulate_plane_events(calib, depth_m=z, jitter_us=2.0),
            cfg.event_capacity,
        )
        for z in depths
    ]
    mesh = make_mesh(jax.devices()[:8], data=2, event=4)
    pipeline = make_sharded_pipeline(cfg, tables, mesh)
    stacked = shard_batches(batches, mesh, cfg)
    out = pipeline(stacked)

    for i, b in enumerate(batches):
        ref = depth_frame(b, tables, cfg)
        np.testing.assert_array_equal(
            np.asarray(out.disp_map)[i], np.asarray(ref.disp_map)
        )
        np.testing.assert_array_equal(
            np.asarray(out.frame_bgr)[i], np.asarray(ref.frame_bgr)
        )
        assert int(out.num_inliers[i]) == int(ref.num_inliers)


def test_mesh_shapes():
    mesh = make_mesh(jax.devices(), data=4, event=2)
    assert mesh.shape == {"data": 4, "event": 2}


def test_sharded_pallas_plans_match(rig):
    """Data-parallel mesh running the engine's own per-frame program
    (host target-sorted staging, runs scatter, crop window) must be
    bit-identical to the plain full-frame sharded pipeline."""
    calib, cfg, tables = rig
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")

    from xmaps.models.depth_pipeline import XMapsDepthEngine
    from xmaps.parallel.sharding import (
        make_group_sharded_pipeline,
        shard_staged_group,
    )

    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=cfg.event_capacity, z_near=cfg.z_near,
        z_far=cfg.z_far,
    )
    assert engine.cfg.tail_crop is not None
    events = [
        simulate_plane_events(calib, depth_m=z, jitter_us=2.0)
        for z in (0.5, 0.7)
    ]
    mesh = make_mesh(jax.devices()[:2], data=2, event=1)
    ref_pipe = make_sharded_pipeline(cfg, tables, mesh)
    fast_pipe = make_group_sharded_pipeline(
        engine.cfg, engine.tables, mesh, presort=True,
    )
    want = ref_pipe(
        shard_batches(
            [EventBatch.from_structured(ev, cfg.event_capacity) for ev in events],
            mesh, cfg,
        )
    )
    got = fast_pipe(
        *shard_staged_group([engine.make_sorted_batch(ev) for ev in events], mesh)
    )
    np.testing.assert_array_equal(np.asarray(got.depth), np.asarray(want.depth))
    np.testing.assert_array_equal(
        np.asarray(got.frame_bgr), np.asarray(want.frame_bgr)
    )
    np.testing.assert_array_equal(
        np.asarray(got.num_inliers), np.asarray(want.num_inliers)
    )


def test_group_sharded_live_path_matches_process_frame(rig):
    """The LIVE group dispatch (host target-sorted staging + runs scatter
    + the engine's tail) sharded over the data axis must match the
    single-chip process_frame bit-for-bit, including list padding for a
    frame count that does not divide the mesh."""
    calib, cfg, tables = rig
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")

    from xmaps.models.depth_pipeline import XMapsDepthEngine

    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=4096, z_near=0.2, z_far=1.2,
    )
    rng = np.random.default_rng(21)
    frames = [
        simulate_plane_events(
            calib, depth_m=0.45 + 0.07 * i, subsample=0.3, jitter_us=2.0,
            rng=rng,
        )
        for i in range(6)  # 6 frames on a 4-device mesh -> 2 pad frames
    ]
    mesh = make_mesh(jax.devices()[:4], data=4, event=1)
    out = engine.process_frames_sharded(frames, mesh)
    assert len(out) == 6
    for ev, got in zip(frames, out):
        ref = engine.process_frame(ev)
        np.testing.assert_array_equal(
            np.asarray(got.disp_map), np.asarray(ref.disp_map)
        )
        np.testing.assert_array_equal(
            np.asarray(got.depth), np.asarray(ref.depth)
        )
        np.testing.assert_array_equal(
            np.asarray(got.frame_bgr), np.asarray(ref.frame_bgr)
        )
        assert int(got.num_inliers) == int(ref.num_inliers)
    # one compiled program per (B, mode, mesh)
    assert len(engine._sharded_group_cache) == 1


@pytest.mark.parametrize("data,event", [(2, 2), (2, 4)])
def test_event_sharded_crop_window_matches_full_frame(rig, data, event):
    """The event-axis all-reduce over the tail's crop window (a few
    percent of the map at the ESL rig) is invisible in the result: equal
    to the single-device full-frame program."""
    calib, cfg, tables = rig
    if len(jax.devices()) < data * event:
        pytest.skip(f"needs {data * event} devices")
    from xmaps.calib.maps import CamProjMaps
    from xmaps.ops.image_tail import tail_crop_window

    maps = CamProjMaps(calib)
    crop = tail_crop_window(
        maps.disp_proj_mapx_i16, maps.disp_proj_mapy_i16,
        calib.rect_image_height, calib.rect_image_width,
    )
    assert crop[2] * crop[3] < cfg.rect_height * cfg.rect_width
    batches = [
        EventBatch.from_structured(
            simulate_plane_events(calib, depth_m=z, jitter_us=2.0),
            cfg.event_capacity,
        )
        for z in (0.5, 0.6, 0.7, 0.8)[:data]
    ]
    mesh = make_mesh(jax.devices()[: data * event], data=data, event=event)
    pipeline = make_sharded_pipeline(cfg.replace(tail_crop=crop), tables, mesh)
    out = pipeline(shard_batches(batches, mesh, cfg))
    for i, b in enumerate(batches):
        ref = depth_frame(b, tables, cfg)
        for f in ("disp_map", "depth", "frame_bgr"):
            np.testing.assert_array_equal(
                np.asarray(getattr(out, f))[i], np.asarray(getattr(ref, f))
            )
        assert int(out.num_inliers[i]) == int(ref.num_inliers)
