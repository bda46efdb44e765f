"""The per-event stage (XLA gathers through the packed camera LUT and the
X-map) and host target-sorted staging, against the NumPy oracle and the
arrival-order program."""

import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from xmaps.models.depth_pipeline import XMapsDepthEngine
from xmaps.ops.disparity import compute_event_disparity, rectify_events_packed
from xmaps.ops.event_batch import EventBatch
from xmaps.ops.frame_pipeline import depth_frame
from xmaps.utils.synthetic import (
    make_synthetic_calibration,
    simulate_plane_events,
)

CAPACITY = 2048

# (cam_w, cam_h, proj_w, proj_h, rect (H, W) override): a demo-like rig
# (2.75x camera rectification) and a tall ESL-like one (rect = 3x the
# projector, so the X-map has 3 * proj_h rows -- 5760 at the real rig)
RIGS = {
    "demo_like": (128, 96, 96, 128, None),
    "esl_like": (128, 96, 72, 128, (3 * 128, 3 * 72)),
}


def _rig(name):
    import dataclasses

    cw, ch, pw, ph, rect = RIGS[name]
    calib = make_synthetic_calibration(
        camera_width=cw, camera_height=ch, projector_width=pw, projector_height=ph
    )
    if rect is not None:
        calib = dataclasses.replace(
            calib, rect_image_height=rect[0], rect_image_width=rect[1]
        )
    engine = XMapsDepthEngine.from_calibration(
        calib, event_capacity=CAPACITY, z_near=0.2, z_far=1.2,
    )
    return calib, engine


@pytest.fixture(scope="module")
def rig():
    calib, engine = _rig("demo_like")
    events = simulate_plane_events(
        calib, depth_m=0.6, subsample=0.4, jitter_us=2.0,
        rng=np.random.default_rng(3),
    )
    return calib, engine, events


@pytest.mark.parametrize("name", sorted(RIGS))
def test_xla_event_stage_matches_oracle(name):
    """Rectify + X-map lookup + disparity + inlier mask, per event, equal
    the reference transcription (tests/oracle.py)."""
    calib, engine = _rig(name)
    assert engine.x_map_np.shape[0] == calib.rect_image_height
    events = simulate_plane_events(
        calib, depth_m=0.55, subsample=0.2, jitter_us=2.0,
        rng=np.random.default_rng(31),
    )[: CAPACITY - 48]
    n = len(events)
    t = engine.tables
    batch = EventBatch.from_structured(events, CAPACITY)
    xr, yr = rectify_events_packed(batch.x, batch.y, t.cam_map_packed)
    res = compute_event_disparity(
        batch, t.cam_mapx_i16, t.cam_mapy_i16, t.x_map,
        t_px_scale=engine.cfg.t_px_scale, rect_coords=(xr, yr),
    )
    oxr, oyr = oracle.oracle_rectify_i16(
        events, engine.maps.disp_cam_mapx_i16, engine.maps.disp_cam_mapy_i16
    )
    odisp, oinl, _ = oracle.oracle_disparity(
        oxr, oyr, events["t"], engine.x_map_np, engine.cfg.t_px_scale
    )
    np.testing.assert_array_equal(np.asarray(res.x_rect)[:n], oxr)
    np.testing.assert_array_equal(np.asarray(res.y_rect)[:n], oyr)
    np.testing.assert_array_equal(np.asarray(res.inlier)[:n], oinl)
    np.testing.assert_array_equal(np.asarray(res.disp)[:n][oinl], odisp)
    assert not np.asarray(res.inlier)[n:].any()  # padding lanes
    assert oinl.mean() > 0.5


def test_disparity_stage_matches_xla(rig):
    """The packed-LUT rectify (one gather) equals the two-table rectify,
    and the disparity stage is lane-order independent: a host-sorted
    batch gives the same per-event values as the arrival-order batch
    once undone through the carried priority."""
    calib, engine, events = rig
    t = engine.tables
    batch = engine.make_batch(events)
    ref = compute_event_disparity(
        batch, t.cam_mapx_i16, t.cam_mapy_i16, t.x_map,
        t_px_scale=engine.cfg.t_px_scale,
    )
    xr, yr = rectify_events_packed(batch.x, batch.y, t.cam_map_packed)
    np.testing.assert_array_equal(np.asarray(xr), np.asarray(ref.x_rect))
    np.testing.assert_array_equal(np.asarray(yr), np.asarray(ref.y_rect))

    sb, prio = engine.make_sorted_batch(events)
    res = compute_event_disparity(
        sb, t.cam_mapx_i16, t.cam_mapy_i16, t.x_map,
        t_px_scale=engine.cfg.t_px_scale,
    )
    n = len(events)
    order = np.asarray(prio)[:n]
    for f in ("x_rect", "y_rect", "disp", "inlier"):
        np.testing.assert_array_equal(
            np.asarray(getattr(res, f))[:n],
            np.asarray(getattr(ref, f))[order],
            err_msg=f,
        )


@pytest.mark.parametrize("camera_perspective", [False, True])
def test_full_frame_bit_exact(rig, camera_perspective):
    """Host target-sorted staging + runs scatter equals the arrival-order
    frame (scatter-max) in both views."""
    calib, engine, events = rig
    cfg = engine.cfg.replace(camera_perspective=camera_perspective)
    ref = depth_frame(engine.make_batch(events), engine.tables, cfg)
    b, prio = engine.make_sorted_batch(events)
    got = depth_frame(
        b, engine.tables, cfg, presort_priority=prio, presort_runs=True
    )
    np.testing.assert_array_equal(np.asarray(got.disp_map), np.asarray(ref.disp_map))
    np.testing.assert_array_equal(np.asarray(got.depth), np.asarray(ref.depth))
    np.testing.assert_array_equal(
        np.asarray(got.frame_bgr), np.asarray(ref.frame_bgr)
    )
    assert int(got.num_inliers) == int(ref.num_inliers)


def test_presorted_staging_bit_exact(rig):
    """Host y-sorted staging (from_structured_sorted + presort_priority,
    scatter-max over the carried priorities) must produce the same frame
    as arrival-order staging."""
    calib, engine, _ = rig
    events = simulate_plane_events(
        calib, depth_m=0.7, subsample=0.4, jitter_us=2.0,
        rng=np.random.default_rng(11),
    )
    b0 = EventBatch.from_structured(events, CAPACITY)
    bs, prio = EventBatch.from_structured_sorted(events, CAPACITY)
    # the sorted batch is a y-sorted permutation of the same events
    order = np.asarray(prio)[: len(events)]
    np.testing.assert_array_equal(np.asarray(bs.x)[: len(events)],
                                  np.asarray(b0.x)[order])
    assert (np.diff(np.asarray(bs.y)[: len(events)]) >= 0).all()

    ref = depth_frame(b0, engine.tables, engine.cfg)
    got = depth_frame(bs, engine.tables, engine.cfg, presort_priority=prio)
    np.testing.assert_array_equal(np.asarray(got.disp_map), np.asarray(ref.disp_map))
    np.testing.assert_array_equal(np.asarray(got.depth), np.asarray(ref.depth))
    np.testing.assert_array_equal(np.asarray(got.frame_bgr), np.asarray(ref.frame_bgr))
    assert int(got.num_inliers) == int(ref.num_inliers)


def test_float_t_falls_back(rig):
    """The eval path (float normalized timestamps) runs the float time
    binning; a host priority is refused for it."""
    calib, engine, events = rig
    batch = engine.make_batch(events)
    fbatch = EventBatch(
        x=batch.x,
        y=batch.y,
        t=(batch.t.astype(jnp.float32) / jnp.maximum(batch.t.max(), 1)),
        p=batch.p,
        valid=batch.valid,
        count=batch.count,
    )
    got = depth_frame(fbatch, engine.tables, engine.cfg)
    assert int(got.num_inliers) > 0
    with pytest.raises(ValueError, match="presort_priority"):
        depth_frame(
            fbatch, engine.tables, engine.cfg,
            presort_priority=jnp.arange(CAPACITY, dtype=jnp.int32),
        )
